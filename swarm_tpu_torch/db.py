"""Sequence database: fasta parsing, nucleotide codes, abundances, sorting.

Behaviour-compatible with the reference parser (src/db.cc). Sequences
are stored as one contiguous arena of 2-bit codes (A=0, C=1, G=2, T/U=3,
one byte per nucleotide on the host side — the device pipeline re-packs
them as needed), indexed by (offset, length). The amplicon index is
sorted by decreasing abundance then lexicographic header, which is the
anchor of swarm's output determinism.
"""

import io
import os
import stat
import sys
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .fatal import ERROR_PREFIX, fatal
from .params import Parameters
from .progress import Progress

MAX_SEQUENCE_LENGTH = 67108861  # 2^26 - 3 (reference: src/db.cc:439)
MAX_HEADER_LENGTH = 16777216 - 1  # 2^24 - 1 (reference: src/db.cc:443)
INT64_MAX = (1 << 63) - 1

# 256-entry map: A/a->1, C/c->2, G/g->3, T/t/U/u->4, else 0
_NT_MAP = np.zeros(256, dtype=np.uint8)
for _ch, _code in (("Aa", 1), ("Cc", 2), ("Gg", 3), ("TtUu", 4)):
    for _c in _ch:
        _NT_MAP[ord(_c)] = _code

_TRANSLATE = bytes(_NT_MAP.tolist())

SYM_NT = "-ACGT"

# code byte (0..3) -> ACGT ascii, for fast sequence materialization
_CODE_TO_ACGT = bytes(b"ACGT"[min(i, 3)] for i in range(256))


@dataclass
class Db:
    """Amplicon database after parsing and abundance sorting."""

    _headers: List[bytes] = field(default_factory=list)
    codes: np.ndarray = None  # uint8 arena of 0..3 codes, concatenated
    offsets: np.ndarray = None  # int64 [n]
    lengths: np.ndarray = None  # int64 [n]
    abundances: np.ndarray = None  # uint64-valued int64 [n] (<= 2^63-1)
    abundance_start: np.ndarray = None  # int32 [n]
    abundance_end: np.ndarray = None  # int32 [n]
    longest: int = 0
    nucleotides: int = 0
    n: int = 0
    # header spans into a shared byte buffer (native parse path); the
    # headers list is materialized lazily from these — the C writers
    # work from the spans directly
    hdr_buffer: np.ndarray = None  # uint8
    hdr_off: np.ndarray = None  # int64 [n], sorted order
    hdr_len: np.ndarray = None  # int64 [n]

    @property
    def headers(self) -> List[bytes]:
        if not self._headers and self.hdr_buffer is not None and self.n:
            buf = self.hdr_buffer.tobytes()
            off = self.hdr_off
            ln = self.hdr_len
            self._headers = [
                buf[off[i] : off[i] + ln[i]] for i in range(self.n)
            ]
        return self._headers

    @headers.setter
    def headers(self, value: List[bytes]) -> None:
        self._headers = value
        self.n = len(value)

    def __len__(self) -> int:
        return self.n

    def sequence_codes(self, seqno: int) -> np.ndarray:
        off = self.offsets[seqno]
        return self.codes[off : off + self.lengths[seqno]]

    def sequence_string(self, seqno: int) -> str:
        return (
            self.sequence_codes(seqno)
            .tobytes()
            .translate(_CODE_TO_ACGT)
            .decode("ascii")
        )

    # --- header/abundance printing helpers (reference: src/db.cc:946-1026) ---

    def print_id(self, seqno: int, usearch_abundance: bool, append_abundance: int) -> str:
        header = self.headers[seqno].decode("latin-1")
        if append_abundance != 0 and (
            self.abundance_start[seqno] == self.abundance_end[seqno]
        ):
            if usearch_abundance:
                return f"{header};size={self.abundances[seqno]};"
            return f"{header}_{self.abundances[seqno]}"
        return header

    def print_id_noabundance(self, seqno: int, usearch_abundance: bool) -> str:
        header = self.headers[seqno].decode("latin-1")
        start = self.abundance_start[seqno]
        end = self.abundance_end[seqno]
        hdrlen = len(header)
        if start < end:
            out = header[:start]
            if usearch_abundance:
                if start > 0 and end < hdrlen:
                    out += ";"
                out += header[end:]
            return out
        return header

    def print_id_with_new_abundance(
        self, seqno: int, abundance: int, usearch_abundance: bool
    ) -> str:
        header = self.headers[seqno].decode("latin-1")
        start = self.abundance_start[seqno]
        end = self.abundance_end[seqno]
        if usearch_abundance:
            semicolon = ";" if start > 0 else ""
            return f"{header[:start]}{semicolon}size={abundance};{header[end:]}"
        return f"{header[:start]}_{abundance}"


_DIGITS = set(b"0123456789")


def _find_swarm_abundance(header: bytes):
    """(_)([0-9]+)$ — last underscore followed only by <=20 digits."""
    pos = header.rfind(b"_")
    if pos < 0:
        return None
    digits = header[pos + 1 :]
    n_digits = 0
    for byte in digits:
        if byte in _DIGITS:
            n_digits += 1
        else:
            break
    if n_digits > 20:
        return None
    if n_digits != len(digits):
        return None
    # zero digits MATCHES with number 0 (the reference's strspn+atol
    # accepts "" -> 0, src/db.cc:188-210, and the caller then fatals
    # "Illegal abundance value" — even under -a)
    number = min(int(digits), INT64_MAX) if n_digits > 0 else 0
    return pos, len(header), number


def _find_usearch_abundance(header: bytes):
    """(^|;)size=([0-9]+)(;|$) — replicates the reference scan loop
    (src/db.cc:214-283) including its skip distances."""
    attribute = b"size="
    alen = len(attribute)
    hlen = len(header)
    position = 0
    while position + alen < hlen:
        found = header.find(attribute, position)
        if found < 0:
            break
        position = found
        if position > 0 and header[position - 1 : position] != b";":
            position += alen + 1
            continue
        n_digits = 0
        k = position + alen
        while k < hlen and header[k] in _DIGITS:
            n_digits += 1
            k += 1
        if n_digits == 0:
            position += alen + 1
            continue
        if position + alen + n_digits < hlen and header[
            position + alen + n_digits : position + alen + n_digits + 1
        ] != b";":
            position += alen + n_digits + 2
            continue
        start = position - 1 if position > 0 else 0
        end = min(position + alen + n_digits + 1, hlen)
        number = min(int(header[position + alen : position + alen + n_digits]), INT64_MAX)
        return start, end, number
    return None


def _find_abundance(header: bytes, headerlen: int, lineno: int, p: Parameters):
    """Returns (abundance, start, end, missing)."""
    result = (
        _find_usearch_abundance(header)
        if p.opt_usearch_abundance
        else _find_swarm_abundance(header)
    )
    if result is not None:
        start, end, number = result
        if number <= 0:
            fatal(
                ERROR_PREFIX,
                "Illegal abundance value on line ",
                lineno,
                ":\n",
                header.decode("latin-1"),
                "\nAbundance values should be positive integers.",
            )
        return number, start, end, False

    start = headerlen
    end = headerlen
    if p.opt_append_abundance != 0:
        return p.opt_append_abundance, start, end, False
    return 0, start, end, True


# serving-model DB cache: a resident process (the warm CLI loop, the
# unix-socket server) re-clusters the same input with different
# parameters; the parse + index + abundance sort are pure functions of
# (file content, abundance-syntax flags), so an unchanged file —
# identified the ccache way, by (dev, inode, size, mtime_ns) — reuses
# the previous Db and replays the exact progress/log byte stream. One
# entry; Db arrays are never mutated downstream (writers and engines
# only read). SWARM_TPU_DB_CACHE=0 disables.
_DB_CACHE = {}


def _db_cache_key(p: Parameters, fd):
    if os.environ.get("SWARM_TPU_DB_CACHE", "1") == "0" or fd is None:
        return None
    try:
        st = os.fstat(fd)
    except OSError:
        return None
    if not stat.S_ISREG(st.st_mode):
        return None
    return (
        st.st_dev, st.st_ino, st.st_size, st.st_mtime_ns,
        bool(p.opt_usearch_abundance), int(p.opt_append_abundance or 0),
        p.opt_differences > 1,
    )


def _db_cache_hit(key, p: Parameters, progress: Progress):
    hit = _DB_CACHE.get(key)
    if hit is None:
        return None
    db, filesize, filepos = hit
    from .progress import replay_range, replay_values

    progress.init("Reading sequences:", filesize)
    replay_values(progress, filepos)
    progress.done()
    progress.init("Indexing database:", db.n)
    replay_range(progress, db.n)
    progress.done()
    progress.init("Abundance sorting:", 1)
    progress.done()
    p.logfile.write(
        f"Database info:     {db.nucleotides} nt in {db.n} sequences, "
        f"longest {db.longest} nt\n"
    )
    return db


def db_read(p: Parameters, progress: Progress) -> Db:
    """Parse the fasta input into a Db, checking all reference invariants."""

    # --- open input ---
    if p.input_filename == "-":
        data = sys.stdin.buffer
        try:
            fd = data.fileno()
        except (AttributeError, OSError, ValueError, io.UnsupportedOperation):
            fd = None  # in-memory stdin (resident-server forwarding)
    else:
        try:
            data = open(p.input_filename, "rb")
        except OSError:
            fatal(
                ERROR_PREFIX,
                "Unable to open input data file (",
                p.input_filename,
                ").\n",
            )
        fd = data.fileno()

    try:
        if fd is None:
            # in-memory stdin (resident-server forwarding): same
            # behavior as a pipe on the direct CLI path
            is_regular = False
            filesize = 0
        else:
            mode = os.fstat(fd).st_mode
            is_regular = stat.S_ISREG(mode)
            filesize = os.fstat(fd).st_size if is_regular else 0
    except OSError:
        fatal(
            ERROR_PREFIX,
            "Unable to fstat on input file (",
            p.input_filename,
            ").\n",
        )

    if not is_regular:
        p.logfile.write(
            "Waiting for data... (hit Ctrl-C and run 'swarm -h' if you meant "
            "to read data from a file)\n"
        )

    cache_key = _db_cache_key(p, fd) if is_regular else None
    if cache_key is not None:
        cached = _db_cache_hit(cache_key, p, progress)
        if cached is not None:
            if p.input_filename != "-":
                data.close()
            return cached

    raw = data.read()
    if p.input_filename != "-":
        data.close()

    from . import _native

    if _native.available():
        return _db_read_native(
            p, progress, raw, filesize, is_regular, cache_key
        )

    progress.init("Reading sequences:", filesize)

    # split into lines exactly like repeated getline(): each element is a
    # line without its trailing '\n'; a trailing newline does not create
    # an extra empty line; '\r' is preserved in the line body.
    lines = raw.split(b"\n")
    line_sizes = [len(line) + 1 for line in lines]
    if raw and not raw.endswith(b"\n"):
        line_sizes[-1] -= 1
    if lines and lines[-1] == b"" and (not raw or raw.endswith(b"\n")):
        lines.pop()
        line_sizes.pop()

    headers: List[bytes] = []
    header_linenos: List[int] = []
    seq_chunks: List[bytes] = []  # translated code bytes (values 0..3)
    seq_lengths: List[int] = []
    longest = 0
    longestheader = 0
    nucleotides = 0

    n_lines = len(lines)
    line_index = 0  # 0-based index of the current look-ahead line
    filepos = 0

    if n_lines > 0:
        filepos = line_sizes[0]

    while line_index < n_lines:
        line = lines[line_index]
        if not line.startswith(b">"):
            fatal(ERROR_PREFIX, "Illegal header line in fasta file.")

        # header ends at first space, CR, LF or NUL
        body = line[1:]
        cut = len(body)
        for sep in (b" ", b"\r", b"\x00"):
            idx = body.find(sep)
            if idx >= 0:
                cut = min(cut, idx)
        header = body[:cut]
        longestheader = max(longestheader, len(header))
        if longestheader > MAX_HEADER_LENGTH:
            fatal(
                ERROR_PREFIX,
                "Headers longer than 16,777,215 symbols are not supported.",
            )
        header_lineno = line_index + 1

        # read sequence lines
        line_index += 1
        if line_index < n_lines:
            filepos += line_sizes[line_index]
        parts: List[bytes] = []
        length = 0
        while line_index < n_lines and not lines[line_index].startswith(b">"):
            seq_line = lines[line_index]
            nul = seq_line.find(b"\x00")
            if nul >= 0:
                seq_line = seq_line[:nul]  # C string scan stops at NUL
            translated = seq_line.translate(_TRANSLATE)
            zero = translated.find(b"\x00")
            if zero >= 0:
                # an invalid byte: \r and \n are skipped, rest is fatal
                cleaned = seq_line.replace(b"\r", b"")
                translated = cleaned.translate(_TRANSLATE)
                zero = translated.find(b"\x00")
                if zero >= 0:
                    character = cleaned[zero]
                    lineno = line_index + 1
                    if 32 <= character <= 126:
                        fatal(
                            ERROR_PREFIX,
                            "Illegal character '",
                            chr(character),
                            "' in sequence on line ",
                            lineno,
                            ".",
                        )
                    else:
                        # raw byte, not its decimal (src/db.cc:582-584)
                        fatal(
                            ERROR_PREFIX,
                            "Illegal character (ascii no ",
                            chr(character),
                            ") in sequence on line ",
                            lineno,
                            ".",
                        )
            length += len(translated)
            if length > MAX_SEQUENCE_LENGTH:
                fatal(
                    ERROR_PREFIX,
                    "Sequences longer than 67,108,861 symbols are not supported.",
                )
            parts.append(translated)
            line_index += 1
            if line_index < n_lines:
                filepos += line_sizes[line_index]

        if length == 0:
            # lineno is the number of the look-ahead line (or one past EOF)
            lineno = line_index + 1
            fatal(ERROR_PREFIX, "Empty sequence found on line ", lineno - 1, ".")

        headers.append(header)
        header_linenos.append(header_lineno)
        seq_chunks.append(b"".join(parts))
        seq_lengths.append(length)
        nucleotides += length
        longest = max(longest, length)

        if is_regular:
            progress.update(filepos)

    progress.done()

    n = len(headers)

    # --- abundances and duplicate identifiers ---
    abundances = np.zeros(n, dtype=np.uint64)
    ab_start = np.zeros(n, dtype=np.int32)
    ab_end = np.zeros(n, dtype=np.int32)

    missing_count = 0
    missing_lineno = 0
    missing_header: Optional[bytes] = None

    id_seen = {}
    seq_seen = {} if p.opt_differences > 1 else None
    has_seq_duplicates = False

    progress.init("Indexing database:", n)
    for k in range(n):
        header = headers[k]
        headerlen = len(header)
        abundance, start, end, missing = _find_abundance(
            header, headerlen, header_linenos[k], p
        )
        if missing:
            missing_count += 1
            if missing_count == 1:
                missing_lineno = header_linenos[k]
                missing_header = header
        abundances[k] = abundance
        ab_start[k] = start
        ab_end[k] = end

        if start == 0 and end == headerlen:
            fatal(ERROR_PREFIX, "Empty sequence identifier.")

        # identifier = header minus the abundance annotation
        if start > 0:
            identifier = header[:start]
        else:
            identifier = header[end:]
        if identifier in id_seen:
            fatal(
                ERROR_PREFIX,
                "Duplicated sequence identifier: ",
                identifier.decode("latin-1"),
            )
        id_seen[identifier] = k

        if seq_seen is not None:
            key = seq_chunks[k]
            if key in seq_seen:
                # the reference breaks out immediately, without a
                # progress update for this record (src/db.cc:785-789)
                has_seq_duplicates = True
                break
            seq_seen[key] = k

        progress.update(k)

    if has_seq_duplicates:
        fatal(
            ERROR_PREFIX,
            "some fasta entries have identical sequences.\n"
            "Swarm expects dereplicated fasta files.\n"
            "Such files can be produced with swarm or vsearch:\n"
            " swarm -d 0 -w derep.fasta -o /dev/null input.fasta\n"
            "or\n"
            " vsearch --derep_fulllength input.fasta --sizein --sizeout --output derep.fasta",
        )

    progress.done()

    if missing_count > 0:
        fatal(
            ERROR_PREFIX,
            "Abundance annotations not found for ",
            missing_count,
            " sequences, starting on line ",
            missing_lineno,
            ".\n>",
            missing_header.decode("latin-1"),
            "\n",
            "Fasta headers must end with abundance annotations (_INT or ;size=INT).\n"
            "The -z option must be used if the abundance annotation is in the latter format.\n"
            "Abundance annotations can be produced by dereplicating the sequences.\n"
            'The header is defined as the string comprised between the ">" symbol\n'
            "and the first space or the end of the line, whichever comes first.",
        )

    # --- sort by decreasing abundance then lexicographic header ---
    progress.init("Abundance sorting:", 1)
    order = sorted(range(n), key=lambda i: (-int(abundances[i]), headers[i]))
    progress.done()

    db = Db()
    db.headers = [headers[i] for i in order]
    db.lengths = np.array([seq_lengths[i] for i in order], dtype=np.int64)
    db.offsets = np.zeros(n, dtype=np.int64)
    if n > 0:
        np.cumsum(db.lengths[:-1], out=db.offsets[1:])
    arena = bytearray()
    for i in order:
        arena += seq_chunks[i]
    # translated codes are 1..4; store as 0..3
    codes = np.frombuffer(bytes(arena), dtype=np.uint8)
    db.codes = (codes - 1).astype(np.uint8) if n > 0 else np.zeros(0, dtype=np.uint8)
    db.abundances = abundances[order] if n > 0 else abundances
    db.abundance_start = ab_start[order] if n > 0 else ab_start
    db.abundance_end = ab_end[order] if n > 0 else ab_end
    db.longest = longest
    db.nucleotides = nucleotides

    p.logfile.write(
        f"Database info:     {nucleotides} nt in {n} sequences, longest {longest} nt\n"
    )

    return db

def _db_read_native(p: Parameters, progress: Progress, raw: bytes,
                    filesize: int, is_regular: bool,
                    cache_key=None) -> Db:
    """Native (C) parse path — byte-identical behavior to the Python
    path above, including every fatal message and progress milestone."""
    from . import _native

    progress.init("Reading sequences:", filesize)
    buf_arr = np.frombuffer(raw, dtype=np.uint8)
    try:
        codes_all, seq_off, seq_len, hdr_off, hdr_len, hdr_lineno, filepos = (
            _native.fasta_scan(raw)
        )
    except _native.FastaError as e:
        # the reference prints a progress milestone after each COMPLETED
        # record (progress_update(filepos), src/db.cc:634-636) before the
        # fatal interrupts the phase
        if is_regular and len(e.filepos_done):
            from .progress import replay_values

            replay_values(progress, e.filepos_done)
        if e.code == 1:
            fatal(ERROR_PREFIX, "Illegal header line in fasta file.")
        if e.code == 2:
            fatal(ERROR_PREFIX, "Empty sequence found on line ", e.lineno, ".")
        if e.code == 3:
            if 32 <= e.char <= 126:
                fatal(
                    ERROR_PREFIX,
                    "Illegal character '", chr(e.char),
                    "' in sequence on line ", e.lineno, ".",
                )
            # the reference streams the raw byte itself after "ascii no "
            # (fatal(..., character, ...) with an unsigned char operand,
            # src/db.cc:582-584)
            fatal(
                ERROR_PREFIX,
                "Illegal character (ascii no ", chr(e.char),
                ") in sequence on line ", e.lineno, ".",
            )
        if e.code == 4:
            fatal(
                ERROR_PREFIX,
                "Sequences longer than 67,108,861 symbols are not supported.",
            )
        fatal(
            ERROR_PREFIX,
            "Headers longer than 16,777,215 symbols are not supported.",
        )

    n = len(seq_off)
    if is_regular:
        from .progress import replay_values

        replay_values(progress, filepos)
    progress.done()

    nucleotides = int(seq_len.sum()) if n else 0
    longest = int(seq_len.max()) if n else 0

    # --- abundances and duplicate identifiers ---
    progress.init("Indexing database:", n)
    try:
        abundances, ab_start, ab_end, missing_count, first_missing = (
            _native.index_records(
                buf_arr, hdr_off, hdr_len,
                p.opt_usearch_abundance, p.opt_append_abundance,
            )
        )
    except _native.IndexRecordsError as e:
        k = e.record
        header = raw[hdr_off[k] : hdr_off[k] + hdr_len[k]]
        for j in range(k):
            progress.update(j)
        if e.code == _native.IndexRecordsError.ILLEGAL_ABUNDANCE:
            fatal(
                ERROR_PREFIX,
                "Illegal abundance value on line ", int(hdr_lineno[k]), ":\n",
                header.decode("latin-1"),
                "\nAbundance values should be positive integers.",
            )
        if e.code == _native.IndexRecordsError.EMPTY_IDENTIFIER:
            fatal(ERROR_PREFIX, "Empty sequence identifier.")
        # duplicated identifier
        start, end = 0, len(header)
        res = (
            _find_usearch_abundance(header)
            if p.opt_usearch_abundance
            else _find_swarm_abundance(header)
        )
        if res is not None:
            start, end = res[0], res[1]
        identifier = header[:start] if start > 0 else header[end:]
        fatal(
            ERROR_PREFIX,
            "Duplicated sequence identifier: ",
            identifier.decode("latin-1"),
        )

    if p.opt_differences > 1:
        dup = _native.find_duplicate_seq(codes_all, seq_off, seq_len)
        if dup >= 0:
            # the reference breaks BEFORE updating the duplicate's own
            # record (src/db.cc:785-789), so only 0..dup-1 were updated
            for j in range(dup):
                progress.update(j)
            fatal(
                ERROR_PREFIX,
                "some fasta entries have identical sequences.\n"
                "Swarm expects dereplicated fasta files.\n"
                "Such files can be produced with swarm or vsearch:\n"
                " swarm -d 0 -w derep.fasta -o /dev/null input.fasta\n"
                "or\n"
                " vsearch --derep_fulllength input.fasta --sizein --sizeout --output derep.fasta",
            )
    from .progress import replay_range

    replay_range(progress, n)
    progress.done()

    if missing_count > 0:
        k = first_missing
        header = raw[hdr_off[k] : hdr_off[k] + hdr_len[k]]
        fatal(
            ERROR_PREFIX,
            "Abundance annotations not found for ", missing_count,
            " sequences, starting on line ", int(hdr_lineno[k]), ".\n>",
            header.decode("latin-1"), "\n",
            "Fasta headers must end with abundance annotations (_INT or ;size=INT).\n"
            "The -z option must be used if the abundance annotation is in the latter format.\n"
            "Abundance annotations can be produced by dereplicating the sequences.\n"
            'The header is defined as the string comprised between the ">" symbol\n'
            "and the first space or the end of the line, whichever comes first.",
        )

    # --- sort by decreasing abundance then lexicographic header ---
    progress.init("Abundance sorting:", 1)
    order = _native.abundance_sort(buf_arr, hdr_off, hdr_len, abundances)
    progress.done()

    db = Db()
    db.n = n
    db.hdr_buffer = buf_arr
    db.hdr_off = hdr_off[order]
    db.hdr_len = hdr_len[order]
    db.lengths = seq_len[order].astype(np.int64)
    if n > 0:
        # the arena stays in parse order; only the per-record offsets
        # are permuted — every consumer addresses sequences through
        # (offsets, lengths), so the random-access segment reorder the
        # old gather paid buys nothing. The sequential exact-size copy
        # releases the parse buffer's header/newline overhead instead
        # of pinning it behind a view.
        db.offsets = seq_off[order].astype(np.int64)
        db.codes = codes_all[:nucleotides].copy()
    else:
        db.offsets = np.zeros(n, dtype=np.int64)
        db.codes = np.zeros(0, dtype=np.uint8)
    db.abundances = abundances[order].astype(np.uint64) if n else abundances.astype(np.uint64)
    db.abundance_start = ab_start[order] if n else ab_start
    db.abundance_end = ab_end[order] if n else ab_end
    db.longest = longest
    db.nucleotides = nucleotides

    p.logfile.write(
        f"Database info:     {nucleotides} nt in {n} sequences, longest {longest} nt\n"
    )

    if cache_key is not None and is_regular:
        _DB_CACHE.clear()
        _DB_CACHE[cache_key] = (db, filesize, filepos)

    return db
