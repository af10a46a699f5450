"""User-facing message text.

Byte-identical to the reference implementation's banner and usage text
(reference: src/swarm.cc:127-190) so that black-box tests comparing
stderr/log output pass unchanged.
"""

from . import SWARM_VERSION

HEADER_MESSAGE = (
    f"Swarm {SWARM_VERSION}\n"
    "Copyright (C) 2012-2025 Torbjorn Rognes and Frederic Mahe\n"
    "https://github.com/torognes/swarm\n"
    "\n"
    "Mahe F, Rognes T, Quince C, de Vargas C, Dunthorn M (2014)\n"
    "Swarm: robust and fast clustering method for amplicon-based studies\n"
    "PeerJ 2:e593 https://doi.org/10.7717/peerj.593\n"
    "\n"
    "Mahe F, Rognes T, Quince C, de Vargas C, Dunthorn M (2015)\n"
    "Swarm v2: highly-scalable and high-resolution amplicon clustering\n"
    "PeerJ 3:e1420 https://doi.org/10.7717/peerj.1420\n"
    "\n"
    "Mahe F, Czech L, Stamatakis A, Quince C, de Vargas C, Dunthorn M, Rognes T (2022)\n"
    "Swarm v3: towards tera-scale amplicon clustering\n"
    "Bioinformatics 38:1, 267-269 https://doi.org/10.1093/bioinformatics/btab493\n"
    "\n"
)

USAGE_MESSAGE = (
    "Usage: swarm [OPTIONS] [FASTAFILE]\n"
    "\n"
    "General options:\n"
    " -h, --help                          display this help and exit\n"
    " -t, --threads INTEGER               number of threads to use (1)\n"
    " -v, --version                       display version information and exit\n"
    "\n"
    "Clustering options:\n"
    " -d, --differences INTEGER           resolution (1)\n"
    " -n, --no-otu-breaking               never break clusters (not recommended!)\n"
    "\n"
    "Fastidious options (only when d = 1):\n"
    " -b, --boundary INTEGER              min mass of large clusters (3)\n"
    " -c, --ceiling INTEGER               max memory in MB for Bloom filter (unlim.)\n"
    " -f, --fastidious                    link nearby low-abundance swarms\n"
    " -y, --bloom-bits INTEGER            bits used per Bloom filter entry (16)\n"
    "\n"
    "Input/output options:\n"
    " -a, --append-abundance INTEGER      value to use when abundance is missing\n"
    " -i, --internal-structure FILENAME   write internal cluster structure to file\n"
    " -j, --network-file FILENAME         dump sequence network to file\n"
    " -l, --log FILENAME                  log to file, not to stderr\n"
    " -o, --output-file FILENAME          output result to file (stdout)\n"
    " -r, --mothur                        output using mothur-like format\n"
    " -s, --statistics-file FILENAME      dump cluster statistics to file\n"
    " -u, --uclust-file FILENAME          output using UCLUST-like format to file\n"
    " -w, --seeds FILENAME                write cluster representatives to FASTA file\n"
    " -z, --usearch-abundance             abundance annotation in usearch style\n"
    "\n"
    "Pairwise alignment advanced options (only when d > 1):\n"
    " -m, --match-reward INTEGER          reward for nucleotide match (5)\n"
    " -p, --mismatch-penalty INTEGER      penalty for nucleotide mismatch (4)\n"
    " -g, --gap-opening-penalty INTEGER   gap open penalty (12)\n"
    " -e, --gap-extension-penalty INTEGER gap extension penalty (4)\n"
    " -x, --disable-sse3                  disable SSE3 and later x86 instructions\n"
    "\n"
    "See 'man swarm' for more details.\n"
    "\n"
)
