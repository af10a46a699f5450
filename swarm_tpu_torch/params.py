"""Run parameters and scoring-system derivation.

Mirrors the reference `struct Parameters` defaults (src/swarm.h:54-102)
and the score→cost conversion (src/swarm.cc:466-483).
"""

import math
from dataclasses import dataclass, field


# defaults (reference: src/swarm.h:40-49)
DIFFERENCES_DEFAULT = 1
CEILING_DEFAULT = 0
BOUNDARY_DEFAULT = 3
APPEND_ABUNDANCE_DEFAULT = 0
MISMATCH_PENALTY_DEFAULT = 4
MATCH_REWARD_DEFAULT = 5
GAP_OPENING_PENALTY_DEFAULT = 12
GAP_EXTENSION_PENALTY_DEFAULT = 4
BLOOM_BITS_DEFAULT = 16


@dataclass
class Parameters:
    opt_threads: int = 1
    opt_bloom_bits: int = BLOOM_BITS_DEFAULT
    opt_differences: int = DIFFERENCES_DEFAULT
    opt_mismatch_penalty: int = MISMATCH_PENALTY_DEFAULT
    opt_match_reward: int = MATCH_REWARD_DEFAULT
    opt_gap_opening_penalty: int = GAP_OPENING_PENALTY_DEFAULT
    opt_gap_extension_penalty: int = GAP_EXTENSION_PENALTY_DEFAULT
    opt_ceiling: int = CEILING_DEFAULT
    opt_append_abundance: int = APPEND_ABUNDANCE_DEFAULT
    opt_boundary: int = BOUNDARY_DEFAULT

    # detected host CPU features, used only for log-line compatibility
    mmx_present: int = 0
    sse_present: int = 0
    sse2_present: int = 0
    sse3_present: int = 0
    ssse3_present: int = 0
    sse41_present: int = 0
    sse42_present: int = 0
    popcnt_present: int = 0
    avx_present: int = 0
    avx2_present: int = 0

    penalty_mismatch: int = 2 * MATCH_REWARD_DEFAULT + 2 * MISMATCH_PENALTY_DEFAULT
    penalty_gapextend: int = MATCH_REWARD_DEFAULT + 2 * GAP_EXTENSION_PENALTY_DEFAULT
    penalty_gapopen: int = 2 * GAP_OPENING_PENALTY_DEFAULT

    opt_help: bool = False
    opt_disable_sse3: bool = False
    opt_version: bool = False
    opt_fastidious: bool = False
    opt_usearch_abundance: bool = False
    opt_mothur: bool = False
    opt_no_cluster_breaking: bool = False

    input_filename: str = "-"
    opt_network_file: str = ""
    opt_internal_structure: str = ""
    opt_seeds: str = ""
    opt_statistics_file: str = ""
    opt_uclust_file: str = ""
    opt_output_file: str = "-"
    opt_log: str = ""

    # open file objects (filled by open_files)
    outfile: object = None
    statsfile: object = None
    uclustfile: object = None
    internal_structure_file: object = None
    seeds_file: object = None
    network_file: object = None
    logfile: object = None  # defaults to stderr at runtime


def set_alignment_scoring_system(p: Parameters) -> None:
    """Convert match/mismatch/gap *scores* into a pure *cost* model.

    penalty_mismatch = 2m + 2p, gapopen = 2g, gapextend = m + 2e,
    all divided by their gcd (reference: src/swarm.cc:466-483).
    """
    p.penalty_mismatch = 2 * p.opt_match_reward + 2 * p.opt_mismatch_penalty
    p.penalty_gapopen = 2 * p.opt_gap_opening_penalty
    p.penalty_gapextend = p.opt_match_reward + 2 * p.opt_gap_extension_penalty

    factor = math.gcd(
        math.gcd(p.penalty_mismatch, p.penalty_gapopen), p.penalty_gapextend
    )
    p.penalty_mismatch //= factor
    p.penalty_gapopen //= factor
    p.penalty_gapextend //= factor
