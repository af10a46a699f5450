"""ctypes loader for the native host runtime (swarm_native.c).

Own copy of swarm_tpu/_native (same C source, same typed wrappers).
The shared library is compiled with the system compiler when this
module is first imported, into ``_native_build/`` next to the package,
named by a hash of the source and the host, and bound with ctypes. The
port requires the library: a failed build raises ImportError.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "swarm_native.c"
BUILD_DIR = _DIR.parent / "_native_build"

I64 = ctypes.POINTER(ctypes.c_int64)
I32 = ctypes.POINTER(ctypes.c_int32)
U8 = ctypes.POINTER(ctypes.c_uint8)


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(
        {1: U8, 4: I32, 8: I64}[arr.dtype.itemsize]
    )


def library_path() -> Path:
    """Source content hash + host ISA and name, so a library from
    another machine or an edited source is never loaded (a
    -march=native build would SIGILL on a host without the build
    features)."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(f":{platform.machine()}:{platform.node()}".encode())
    return BUILD_DIR / f"libswarm_native_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    # -march=native unlocks hardware popcnt/AVX2/AVX-512 for the qgram
    # screens and the 16-lane banded DP (the build host is the run
    # host); plain -O2 is the fallback
    flag_sets = (["-O3", "-march=native"], ["-O2"])
    last_err = b""
    for flags in flag_sets:
        for cc in ("cc", "gcc", "clang"):
            try:
                r = subprocess.run(
                    [cc, *flags, "-pthread", "-shared", "-fPIC", str(_SRC),
                     "-o", str(tmp)],
                    capture_output=True,
                    timeout=120,
                )
            except (OSError, subprocess.TimeoutExpired):
                continue
            if r.returncode == 0:
                if flags != flag_sets[0] and last_err:
                    # a silent fallback to -O2 once hid a source
                    # error and quietly disabled every SIMD kernel;
                    # make degraded builds loud
                    sys.stderr.write(
                        "swarm_tpu_torch/_native: -march=native build "
                        "FAILED, using the slow -O2 fallback:\n"
                        + last_err.decode("utf-8", "replace")[-2000:]
                        + "\n"
                    )
                os.replace(tmp, so)  # atomic: concurrent builds agree
                return so
            last_err = r.stderr or last_err
    tmp.unlink(missing_ok=True)
    raise ImportError(
        "swarm_tpu_torch/_native: no C compiler built swarm_native.c:\n"
        + last_err.decode("utf-8", "replace")[-2000:])


lib = ctypes.CDLL(str(_build()))
lib.fasta_scan.restype = ctypes.c_int64
lib.index_records.restype = ctypes.c_int64
lib.find_duplicate_seq.restype = ctypes.c_int64
lib.abundance_sort.restype = None
lib.bfs_cluster.restype = ctypes.c_int64
lib.sort_seeds_stdcxx.restype = ctypes.c_int


def available() -> bool:
    """Always True once this module has imported: the build raises
    otherwise. Kept so the copied host layers read like their
    originals."""
    return True


def fasta_scan(buf: bytes):
    """Returns (codes, seq_off, seq_len, hdr_off, hdr_len, hdr_lineno,
    filepos) or raises FastaError(code, lineno, char)."""
    raw = np.frombuffer(buf, dtype=np.uint8)
    buflen = len(raw)
    max_records = buf.count(b"\n>") + (1 if buf.startswith(b">") else 0) + 1
    codes = np.empty(buflen + 1, dtype=np.uint8)
    seq_off = np.empty(max_records, dtype=np.int64)
    seq_len = np.empty(max_records, dtype=np.int64)
    hdr_off = np.empty(max_records, dtype=np.int64)
    hdr_len = np.empty(max_records, dtype=np.int64)
    hdr_lineno = np.empty(max_records, dtype=np.int64)
    filepos = np.empty(max_records, dtype=np.int64)
    err = np.zeros(4, dtype=np.int64)
    n = lib.fasta_scan(
        _ptr(raw) if buflen else U8(),
        ctypes.c_int64(buflen),
        _ptr(codes), _ptr(seq_off), _ptr(seq_len), _ptr(hdr_off),
        _ptr(hdr_len), _ptr(hdr_lineno), _ptr(filepos),
        ctypes.c_int64(max_records), _ptr(err),
    )
    if n < 0:
        raise FastaError(
            int(err[0]), int(err[1]), int(err[2]),
            filepos[: int(err[3])].copy(),
        )
    return (
        codes, seq_off[:n], seq_len[:n], hdr_off[:n], hdr_len[:n],
        hdr_lineno[:n], filepos[:n],
    )


class FastaError(Exception):
    def __init__(self, code, lineno, char, filepos_done=None):
        super().__init__(code, lineno, char)
        self.code = code
        self.lineno = lineno
        self.char = char
        # progress positions of the records completed before the error:
        # the reference prints their milestones before fataling
        self.filepos_done = filepos_done if filepos_done is not None else []


def index_records(buf_arr, hdr_off, hdr_len, usearch, append_ab):
    """Returns (abundance, ab_start, ab_end, missing_count, first_missing)
    or raises IndexError-like IndexRecordsError(code, record)."""
    n = len(hdr_off)
    abundance = np.empty(n, dtype=np.int64)
    ab_start = np.empty(n, dtype=np.int32)
    ab_end = np.empty(n, dtype=np.int32)
    missing = np.zeros(1, dtype=np.int64)
    first_missing = np.zeros(1, dtype=np.int64)
    err_idx = np.zeros(1, dtype=np.int64)
    rc = lib.index_records(
        _ptr(buf_arr), _ptr(hdr_off), _ptr(hdr_len), ctypes.c_int64(n),
        ctypes.c_int(1 if usearch else 0), ctypes.c_int64(append_ab),
        _ptr(abundance), _ptr(ab_start), _ptr(ab_end),
        _ptr(missing), _ptr(first_missing), _ptr(err_idx),
    )
    if rc < 0:
        raise MemoryError("index_records")
    if rc > 0:
        raise IndexRecordsError(int(rc), int(err_idx[0]))
    return abundance, ab_start, ab_end, int(missing[0]), int(first_missing[0])


class IndexRecordsError(Exception):
    ILLEGAL_ABUNDANCE = 1
    EMPTY_IDENTIFIER = 2
    DUPLICATED_ID = 3

    def __init__(self, code, record):
        super().__init__(code, record)
        self.code = code
        self.record = record


def find_duplicate_seq(codes, seq_off, seq_len) -> int:
    n = len(seq_off)
    return int(
        lib.find_duplicate_seq(
            _ptr(codes), _ptr(np.ascontiguousarray(seq_off, dtype=np.int64)),
            _ptr(np.ascontiguousarray(seq_len, dtype=np.int64)),
            ctypes.c_int64(n),
        )
    )


def d1_finish_edges(ga, gb, abundances, no_break):
    """Unique verified pairs (a < b, sorted by (a, b)) -> directed
    edges under the abundance rule, sorted by (from, to). Three linear
    passes (swarm_native.c: d1_finish_edges); same contract as the
    numpy expand + lexsort it replaces."""
    ga = np.ascontiguousarray(ga, dtype=np.int64)
    gb = np.ascontiguousarray(gb, dtype=np.int64)
    abundances = np.ascontiguousarray(abundances, dtype=np.int64)
    m = len(ga)
    n = len(abundances)
    ef = np.empty(2 * m, dtype=np.int64)
    et = np.empty(2 * m, dtype=np.int64)
    lib.d1_finish_edges.restype = ctypes.c_int64
    w = int(
        lib.d1_finish_edges(
            _ptr(ga), _ptr(gb), ctypes.c_int64(m), _ptr(abundances),
            ctypes.c_int(1 if no_break else 0), ctypes.c_int64(n),
            _ptr(ef), _ptr(et),
        )
    )
    if w < 0:
        raise MemoryError("d1_finish_edges")
    return ef[:w], et[:w]


def variant_count_total(codes, offsets, lengths, ids) -> int:
    """Exact reference variant count sum(6L + 4 + runs) over ids
    (fastidious log accounting, src/algod1.cc:1436-1472)."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    lib.variant_count_total.restype = ctypes.c_int64
    return int(
        lib.variant_count_total(
            _ptr(codes),
            _ptr(np.ascontiguousarray(offsets, dtype=np.int64)),
            _ptr(np.ascontiguousarray(lengths, dtype=np.int64)),
            _ptr(ids), ctypes.c_int64(len(ids)),
        )
    )


def abundance_sort(buf_arr, hdr_off, hdr_len, abundance):
    n = len(hdr_off)
    order = np.empty(n, dtype=np.int64)
    lib.abundance_sort(
        _ptr(buf_arr), _ptr(hdr_off), _ptr(hdr_len),
        _ptr(np.ascontiguousarray(abundance, dtype=np.int64)),
        ctypes.c_int64(n), _ptr(order),
    )
    return order


def bfs_cluster(n, link_start, link_count, edges_to, abundance, lengths):
    """Returns (nswarms, swarmid, parent, generation, members,
    swarm_bound, seed, mass, sumlen, size, singletons, maxgen)."""
    swarmid = np.empty(n, dtype=np.int64)
    parent = np.empty(n, dtype=np.int64)
    generation = np.zeros(n, dtype=np.int64)
    members = np.empty(n, dtype=np.int64)
    swarm_bound = np.empty(n + 1, dtype=np.int64)
    seed = np.empty(n, dtype=np.int64)
    mass = np.empty(n, dtype=np.int64)
    sumlen = np.empty(n, dtype=np.int64)
    size = np.empty(n, dtype=np.int64)
    singletons = np.empty(n, dtype=np.int64)
    maxgen = np.empty(n, dtype=np.int64)
    nswarms = lib.bfs_cluster(
        ctypes.c_int64(n),
        _ptr(np.ascontiguousarray(link_start, dtype=np.int64)),
        _ptr(np.ascontiguousarray(link_count, dtype=np.int64)),
        _ptr(np.ascontiguousarray(edges_to, dtype=np.int64)),
        _ptr(np.ascontiguousarray(abundance, dtype=np.int64)),
        _ptr(np.ascontiguousarray(lengths, dtype=np.int64)),
        _ptr(swarmid), _ptr(parent), _ptr(generation), _ptr(members),
        _ptr(swarm_bound), _ptr(seed), _ptr(mass), _ptr(sumlen),
        _ptr(size), _ptr(singletons), _ptr(maxgen),
    )
    if nswarms < 0:
        raise MemoryError("bfs_cluster")
    k = int(nswarms)
    return (
        k, swarmid, parent, generation, members, swarm_bound[: k + 1],
        seed[:k], mass[:k], sumlen[:k], size[:k], singletons[:k], maxgen[:k],
    )


lib.nw_backtrack_batch.restype = None


def nw_backtrack_batch(qseq, dseqs, dlens, dirs):
    """diffs/alignlengths along the tie-broken optimal paths.

    qseq: [qlen] u8; dseqs: [B, dlen_max] u8; dlens: [B] i64;
    dirs: [B, dlen_max, qlen] u8 direction bits.
    """
    B, dlen_max = dseqs.shape
    qlen = len(qseq)
    diffs = np.empty(B, dtype=np.int64)
    alignlengths = np.empty(B, dtype=np.int64)
    lib.nw_backtrack_batch(
        _ptr(np.ascontiguousarray(qseq, dtype=np.uint8)),
        ctypes.c_int64(qlen),
        _ptr(np.ascontiguousarray(dseqs, dtype=np.uint8)),
        _ptr(np.ascontiguousarray(dlens, dtype=np.int64)),
        ctypes.c_int64(dlen_max),
        _ptr(np.ascontiguousarray(dirs, dtype=np.uint8)),
        ctypes.c_int64(B), _ptr(diffs), _ptr(alignlengths),
    )
    return diffs, alignlengths


lib.gather_arena.restype = None


def gather_arena(codes, seq_off, seq_len, order, total):
    out = np.empty(total, dtype=np.uint8)
    lib.gather_arena(
        _ptr(codes),
        _ptr(np.ascontiguousarray(seq_off, dtype=np.int64)),
        _ptr(np.ascontiguousarray(seq_len, dtype=np.int64)),
        _ptr(np.ascontiguousarray(order, dtype=np.int64)),
        ctypes.c_int64(len(order)), _ptr(out),
    )
    return out


lib.pad_rows.restype = None
lib.pack_rows.restype = None


def pad_rows(arena, offsets, lengths, width):
    n = len(offsets)
    out = np.empty((n, width), dtype=np.uint8)
    lib.pad_rows(
        _ptr(arena),
        _ptr(np.ascontiguousarray(offsets, dtype=np.int64)),
        _ptr(np.ascontiguousarray(lengths, dtype=np.int64)),
        ctypes.c_int64(n), ctypes.c_int64(width), _ptr(out),
    )
    return out


def pack_rows(padded):
    n, width = padded.shape
    out = np.empty((n, width // 16), dtype=np.uint32)
    lib.pack_rows(
        _ptr(np.ascontiguousarray(padded)), ctypes.c_int64(n),
        ctypes.c_int64(width),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out


lib.nw_align.restype = None

_NW_SCRATCH = {}


def nw_align(dseq, qseq, mismatch, gapopen, gapextend):
    """(nwdiff, alignment_length, cigar) — output-only scalar NW."""
    dlen = len(dseq)
    qlen = len(qseq)
    key = "bufs"
    bufs = _NW_SCRATCH.get(key)
    need = dlen * qlen
    if bufs is None or bufs[0].size < need or bufs[1].size < qlen:
        dirs = np.empty(max(need, 1 << 16), dtype=np.uint8)
        H = np.empty(max(qlen, 4096), dtype=np.int64)
        E = np.empty(max(qlen, 4096), dtype=np.int64)
        raw = ctypes.create_string_buffer(int(2 * (dirs.size ** 0.5) + 16) * 8)
        _NW_SCRATCH[key] = bufs = (dirs, H, E)
    dirs, H, E = bufs
    raw = ctypes.create_string_buffer(dlen + qlen + 2)
    cigar = ctypes.create_string_buffer(8 * (dlen + qlen) + 16)
    out3 = np.zeros(3, dtype=np.int64)
    lib.nw_align(
        _ptr(np.ascontiguousarray(dseq, dtype=np.uint8)), ctypes.c_int64(dlen),
        _ptr(np.ascontiguousarray(qseq, dtype=np.uint8)), ctypes.c_int64(qlen),
        ctypes.c_int64(mismatch), ctypes.c_int64(gapopen),
        ctypes.c_int64(gapextend),
        _ptr(dirs), _ptr(H), _ptr(E), raw, cigar, _ptr(out3),
    )
    return int(out3[0]), int(out3[1]), cigar.value[: out3[2]].decode("ascii")


def nw_align_banded(dseq, qseq, mismatch, gapopen, gapextend, band):
    """Banded variant of nw_align; returns None when the band-exit
    bound rejects (caller must use the full matrix)."""
    dlen = len(dseq)
    qlen = len(qseq)
    lib.nw_align_banded.restype = ctypes.c_int
    B = 2 * band + abs(qlen - dlen) + 1
    dirs = np.empty(max(dlen * B, 1), dtype=np.uint8)
    H = np.empty(max(qlen, 1), dtype=np.int64)
    E = np.empty(max(qlen, 1), dtype=np.int64)
    raw = ctypes.create_string_buffer(dlen + qlen + 2)
    cigar = ctypes.create_string_buffer(8 * (dlen + qlen) + 16)
    out3 = np.zeros(3, dtype=np.int64)
    ok = lib.nw_align_banded(
        _ptr(np.ascontiguousarray(dseq, dtype=np.uint8)), ctypes.c_int64(dlen),
        _ptr(np.ascontiguousarray(qseq, dtype=np.uint8)), ctypes.c_int64(qlen),
        ctypes.c_int64(mismatch), ctypes.c_int64(gapopen),
        ctypes.c_int64(gapextend), ctypes.c_int64(band),
        _ptr(dirs), _ptr(H), _ptr(E), raw, cigar, _ptr(out3),
    )
    if not ok:
        return None
    return int(out3[0]), int(out3[1]), cigar.value[: out3[2]].decode("ascii")


lib.write_swarms_plain.restype = ctypes.c_int64
lib.write_stats_d1.restype = ctypes.c_int64


class HeaderArena:
    """Header bytes + spans, shared by the C writers."""

    def __init__(self, db):
        if getattr(db, "hdr_buffer", None) is not None:
            # native parse path: spans point into the raw input buffer
            self.arena = db.hdr_buffer
            self.hdr_off = np.ascontiguousarray(db.hdr_off, dtype=np.int64)
            self.hdr_len = np.ascontiguousarray(db.hdr_len, dtype=np.int64)
        else:
            self.arena = np.frombuffer(b"".join(db.headers), dtype=np.uint8)
            lens = np.array([len(h) for h in db.headers], dtype=np.int64)
            offs = np.zeros(len(lens), dtype=np.int64)
            if len(lens):
                np.cumsum(lens[:-1], out=offs[1:])
            self.hdr_off = offs
            self.hdr_len = lens
        self.ab_start = np.ascontiguousarray(db.abundance_start, dtype=np.int32)
        self.ab_end = np.ascontiguousarray(db.abundance_end, dtype=np.int32)
        self.abundance = np.ascontiguousarray(db.abundances, dtype=np.int64)


def write_swarms_plain(arena: "HeaderArena", append_ab, usearch,
                       members, bounds, attached) -> bytes:
    total = int(arena.hdr_len[members].sum()) if len(members) else 0
    cap = total + 32 * len(members) + 2 * len(bounds) + 64
    # np.empty, not create_string_buffer: the ctypes buffer zero-fills
    # its (tens of MB) capacity before the writer overwrites it
    out = np.empty(cap, dtype=np.uint8)
    w = lib.write_swarms_plain(
        _ptr(arena.arena), _ptr(arena.hdr_off), _ptr(arena.hdr_len),
        _ptr(arena.ab_start), _ptr(arena.ab_end), _ptr(arena.abundance),
        ctypes.c_int64(append_ab), ctypes.c_int(1 if usearch else 0),
        _ptr(np.ascontiguousarray(members, dtype=np.int64)),
        _ptr(np.ascontiguousarray(bounds, dtype=np.int64)),
        _ptr(np.ascontiguousarray(attached, dtype=np.uint8)),
        ctypes.c_int64(len(bounds) - 1), _ptr(out), ctypes.c_int64(cap),
    )
    if w < 0:
        raise MemoryError("write_swarms_plain buffer")
    return out[:w].tobytes()


def write_structure_d1(arena: "HeaderArena", usearch, members, bounds,
                       attached, graft_cand, parent, generation) -> bytes:
    members = np.ascontiguousarray(members, dtype=np.int64)
    total = int(arena.hdr_len[members].sum()) if len(members) else 0
    cap = 3 * total + 96 * max(len(members), 1) + 64
    out = np.empty(cap, dtype=np.uint8)
    lib.write_structure_d1.restype = ctypes.c_int64
    w = lib.write_structure_d1(
        _ptr(arena.arena), _ptr(arena.hdr_off), _ptr(arena.hdr_len),
        _ptr(arena.ab_start), _ptr(arena.ab_end),
        ctypes.c_int(1 if usearch else 0),
        _ptr(members),
        _ptr(np.ascontiguousarray(bounds, dtype=np.int64)),
        _ptr(np.ascontiguousarray(attached, dtype=np.uint8)),
        ctypes.c_int64(len(bounds) - 1),
        _ptr(np.ascontiguousarray(graft_cand, dtype=np.int64)),
        _ptr(np.ascontiguousarray(parent, dtype=np.int64)),
        _ptr(np.ascontiguousarray(generation, dtype=np.int64)),
        _ptr(out), ctypes.c_int64(cap),
    )
    if w < 0:
        raise MemoryError("write_structure_d1 buffer")
    return out[:w].tobytes()


def write_stats_d1(arena: "HeaderArena", usearch, seed, size, mass,
                   singletons, maxgen, attached) -> bytes:
    nswarms = len(seed)
    seeds_arr = np.ascontiguousarray(seed, dtype=np.int64)
    cap = int(arena.hdr_len[seeds_arr].sum()) + 176 * nswarms + 64 if nswarms else 64
    out = np.empty(cap, dtype=np.uint8)
    w = lib.write_stats_d1(
        _ptr(arena.arena), _ptr(arena.hdr_off), _ptr(arena.hdr_len),
        _ptr(arena.ab_start), _ptr(arena.ab_end), _ptr(arena.abundance),
        ctypes.c_int(1 if usearch else 0),
        _ptr(seeds_arr),
        _ptr(np.ascontiguousarray(size, dtype=np.int64)),
        _ptr(np.ascontiguousarray(mass, dtype=np.int64)),
        _ptr(np.ascontiguousarray(singletons, dtype=np.int64)),
        _ptr(np.ascontiguousarray(maxgen, dtype=np.int64)),
        _ptr(np.ascontiguousarray(attached, dtype=np.uint8)),
        ctypes.c_int64(nswarms), _ptr(out), ctypes.c_int64(cap),
    )
    if w < 0:
        raise MemoryError("write_stats_d1 buffer")
    return out[:w].tobytes()


lib.derep_groups.restype = ctypes.c_int64


def derep_groups(codes, seq_off, seq_len):
    n = len(seq_off)
    group = np.empty(n, dtype=np.int64)
    k = lib.derep_groups(
        _ptr(codes),
        _ptr(np.ascontiguousarray(seq_off, dtype=np.int64)),
        _ptr(np.ascontiguousarray(seq_len, dtype=np.int64)),
        ctypes.c_int64(n), _ptr(group),
    )
    if k < 0:
        raise MemoryError("derep_groups")
    return int(k), group


lib.nw_diffs_batch.restype = None
lib.qgram_profiles_native.restype = None
lib.qgram_profiles_arena.restype = None
lib.nw_diffs_refsched.restype = None

U64 = ctypes.POINTER(ctypes.c_uint64)


def nw_diffs_batch(qseq, dseqs, dlens, mismatch, gapopen, gapextend, sat_max):
    """(scores, diffs, alignlengths) — exact kernel semantics."""
    B, dlen_max = dseqs.shape
    qlen = len(qseq)
    dirs = np.empty(max(dlen_max * qlen, 1), dtype=np.uint8)
    H = np.empty(max(qlen, 1), dtype=np.int64)
    E = np.empty(max(qlen, 1), dtype=np.int64)
    scores = np.empty(B, dtype=np.int64)
    diffs = np.empty(B, dtype=np.int64)
    alignlengths = np.empty(B, dtype=np.int64)
    lib.nw_diffs_batch(
        _ptr(np.ascontiguousarray(qseq, dtype=np.uint8)), ctypes.c_int64(qlen),
        _ptr(np.ascontiguousarray(dseqs, dtype=np.uint8)),
        _ptr(np.ascontiguousarray(dlens, dtype=np.int64)),
        ctypes.c_int64(dlen_max), ctypes.c_int64(B),
        ctypes.c_int64(mismatch), ctypes.c_int64(gapopen),
        ctypes.c_int64(gapextend), ctypes.c_int64(sat_max),
        _ptr(dirs), _ptr(H), _ptr(E),
        _ptr(scores), _ptr(diffs), _ptr(alignlengths),
    )
    return scores, diffs, alignlengths


def qgram_profiles_native(padded, lengths):
    n, width = padded.shape
    profiles = np.zeros((n, 16), dtype=np.uint64)
    lib.qgram_profiles_native(
        _ptr(np.ascontiguousarray(padded)),
        _ptr(np.ascontiguousarray(lengths, dtype=np.int64)),
        ctypes.c_int64(n), ctypes.c_int64(width),
        profiles.ctypes.data_as(U64),
    )
    return profiles


lib.d2_gen1_screen.restype = ctypes.c_int64
lib.d2_subseed_screen.restype = ctypes.c_int64


def d2_gen1_screen(profiles, order, abundances, diffest, swarmed,
                   seed_amp, seed_ab, no_break, d):
    """(hit_positions, hit_ids, n_pool) — writes qgram bounds into
    diffest[swarmed:swarmed+n_pool] in filtered pool order."""
    n = len(order)
    cap = max(n - swarmed, 1)
    out_pos = np.empty(cap, dtype=np.int64)
    out_ids = np.empty(cap, dtype=np.int64)
    n_pool = np.zeros(1, dtype=np.int64)
    hits = lib.d2_gen1_screen(
        profiles.ctypes.data_as(U64), _ptr(order), _ptr(abundances),
        _ptr(diffest), ctypes.c_int64(swarmed), ctypes.c_int64(n),
        ctypes.c_int64(seed_amp), ctypes.c_int64(seed_ab),
        ctypes.c_int(1 if no_break else 0), ctypes.c_int64(d),
        _ptr(out_pos), _ptr(out_ids), _ptr(n_pool),
    )
    return out_pos[:hits], out_ids[:hits], int(n_pool[0])


def d2_subseed_screen(profiles, order, abundances, diffest, swarmed,
                      subseed_amp, bound, subseed_ab, no_break, d):
    """(hit_positions, hit_ids) for one subseed."""
    n = len(order)
    cap = max(n - swarmed, 1)
    out_pos = np.empty(cap, dtype=np.int64)
    out_ids = np.empty(cap, dtype=np.int64)
    hits = lib.d2_subseed_screen(
        profiles.ctypes.data_as(U64), _ptr(order), _ptr(abundances),
        _ptr(diffest), ctypes.c_int64(swarmed), ctypes.c_int64(n),
        ctypes.c_int64(subseed_amp), ctypes.c_int64(bound),
        ctypes.c_int64(subseed_ab), ctypes.c_int(1 if no_break else 0),
        ctypes.c_int64(d), _ptr(out_pos), _ptr(out_ids),
    )
    return out_pos[:hits], out_ids[:hits]


lib.write_uclust_d1.restype = ctypes.c_int64


def write_uclust_d1(db, arena: "HeaderArena", append_ab, usearch,
                    members, bounds, attached, swarm_seed, swarm_size,
                    mismatch, gapopen, gapextend, nthreads=1):
    """uclust output for the d=1 no-graft path, or None on fallback.
    nthreads > 1 renders per-swarm ranges on a pthread pool
    (byte-identical: ranges concatenate in order with rebased cluster
    numbering)."""
    longest = max(int(db.longest), 1)
    lib.write_uclust_d1_mt.restype = ctypes.c_int64

    members = np.ascontiguousarray(members, dtype=np.int64)
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    seeds_arr = np.ascontiguousarray(swarm_seed, dtype=np.int64)
    sizes_arr = np.ascontiguousarray(swarm_size, dtype=np.int64)
    cap = int(
        arena.hdr_len.sum() * 2 + arena.hdr_len[seeds_arr].sum() * 2
        + 200 * len(members) + 16 * longest * len(members) // 8 + 1024
    )
    while True:
        out = ctypes.create_string_buffer(cap)
        w = lib.write_uclust_d1_mt(
            _ptr(db.codes), _ptr(db.offsets), _ptr(db.lengths),
            _ptr(arena.arena), _ptr(arena.hdr_off), _ptr(arena.hdr_len),
            _ptr(arena.ab_start), _ptr(arena.ab_end), _ptr(arena.abundance),
            ctypes.c_int64(append_ab), ctypes.c_int(1 if usearch else 0),
            _ptr(members), _ptr(bounds),
            _ptr(np.ascontiguousarray(attached, dtype=np.uint8)),
            ctypes.c_int64(len(bounds) - 1), _ptr(seeds_arr), _ptr(sizes_arr),
            ctypes.c_int64(mismatch), ctypes.c_int64(gapopen),
            ctypes.c_int64(gapextend), ctypes.c_int64(longest),
            ctypes.c_int64(max(int(nthreads), 1)),
            out, ctypes.c_int64(cap),
        )
        if w == -2:
            return None
        if w == -3:
            raise MemoryError("write_uclust_d1_mt")
        if w < 0:
            cap *= 2
            continue
        return out.raw[:w]


def write_seeds_d1(db, arena: "HeaderArena", usearch,
                   swarm_seed, swarm_mass, attached):
    """-w seeds output ((mass desc, header) order) and the emitted
    record count (reference src/algod1.cc:936-975)."""
    lib.write_seeds_d1.restype = ctypes.c_int64
    seeds_arr = np.ascontiguousarray(swarm_seed, dtype=np.int64)
    mass_arr = np.ascontiguousarray(swarm_mass, dtype=np.int64)
    attached_arr = np.ascontiguousarray(attached, dtype=np.uint8)
    nswarms = len(seeds_arr)
    cap = 64 + (
        int(arena.hdr_len[seeds_arr].sum())
        + int(np.asarray(db.lengths)[seeds_arr].sum())
        + 64 * nswarms
        if nswarms
        else 0
    )
    n_written = np.zeros(1, dtype=np.int64)
    out = ctypes.create_string_buffer(cap)
    w = lib.write_seeds_d1(
        _ptr(arena.arena), _ptr(arena.hdr_off), _ptr(arena.hdr_len),
        _ptr(arena.ab_start), _ptr(arena.ab_end),
        _ptr(db.codes), _ptr(db.offsets), _ptr(db.lengths),
        _ptr(seeds_arr), _ptr(mass_arr), _ptr(attached_arr),
        ctypes.c_int64(nswarms), ctypes.c_int(1 if usearch else 0),
        out, ctypes.c_int64(cap), _ptr(n_written),
    )
    if w < 0:
        raise MemoryError("write_seeds_d1 buffer")
    return out.raw[:w], int(n_written[0])


lib.write_network_d1.restype = ctypes.c_int64


def write_network_d1(arena: "HeaderArena", append_ab, usearch,
                     link_start, link_count, edges_to):
    """Network dump bytes, or None on pathological headers."""
    n = len(link_start)
    edges_to = np.ascontiguousarray(edges_to, dtype=np.int64)
    n_edges = len(edges_to)
    cap = int(arena.hdr_len.sum()) * 2 + 80 * n_edges + 1024
    while True:
        out = ctypes.create_string_buffer(cap)
        w = lib.write_network_d1(
            _ptr(arena.arena), _ptr(arena.hdr_off), _ptr(arena.hdr_len),
            _ptr(arena.ab_start), _ptr(arena.ab_end), _ptr(arena.abundance),
            ctypes.c_int64(append_ab), ctypes.c_int(1 if usearch else 0),
            _ptr(np.ascontiguousarray(link_start, dtype=np.int64)),
            _ptr(np.ascontiguousarray(link_count, dtype=np.int64)),
            _ptr(edges_to), ctypes.c_int64(n), out, ctypes.c_int64(cap),
        )
        if w == -2:
            return None
        if w < 0:
            cap *= 2
            continue
        return out.raw[:w]


def sort_seeds_stdcxx(mass, seed, arena: "HeaderArena") -> bool:
    """libstdc++-exact std::sort of the d>=2 seeds vector (reference
    src/algo.cc:161-183; see swarm_native.c for why exactness of the
    sort ALGORITHM — not just the comparator — is required). Permutes
    the int64 `mass` and `seed` arrays in place; returns False if the
    native path is unavailable (caller uses the Python mirror)."""
    assert mass.dtype == np.int64 and seed.dtype == np.int64
    rc = lib.sort_seeds_stdcxx(
        _ptr(mass), _ptr(seed), ctypes.c_int64(len(mass)),
        _ptr(arena.arena), _ptr(arena.hdr_off), _ptr(arena.hdr_len),
    )
    return rc == 0


def nw_diffs_refsched(qseq, dseqs, dlens, compute,
                      mismatch, gapopen, gapextend, bit_mode):
    """(scores, diffs, alignlengths) — reference-BINARY semantics with
    the compiled-in left-boundary artifact (see swarm_native.c). dseqs
    must be the full ordered target list of one search_do call."""
    B, dlen_max = dseqs.shape
    qlen = len(qseq)
    dlens = np.ascontiguousarray(dlens, dtype=np.int64)
    total_blocks = int(np.sum((dlens + 3) // 4))
    dirs = np.empty(max(dlen_max * qlen, 1), dtype=np.uint8)
    HE = np.empty(max(2 * qlen, 1), dtype=np.uint32)
    start_iter = np.empty(max(B, 1), dtype=np.int64)
    junk = np.empty(2 * (total_blocks + 2), dtype=np.uint32)
    scores = np.empty(B, dtype=np.int64)
    diffs = np.empty(B, dtype=np.int64)
    alignlengths = np.empty(B, dtype=np.int64)
    if compute is None:
        compute_ptr = None
    else:
        compute = np.ascontiguousarray(compute, dtype=np.uint8)
        compute_ptr = _ptr(compute)
    lib.nw_diffs_refsched(
        _ptr(np.ascontiguousarray(qseq, dtype=np.uint8)), ctypes.c_int64(qlen),
        _ptr(np.ascontiguousarray(dseqs, dtype=np.uint8)),
        _ptr(dlens), ctypes.c_int64(dlen_max), ctypes.c_int64(B),
        compute_ptr,
        ctypes.c_int64(mismatch), ctypes.c_int64(gapopen),
        ctypes.c_int64(gapextend), ctypes.c_int64(bit_mode),
        _ptr(dirs), _ptr(HE.view(np.uint32)), _ptr(start_iter), _ptr(junk),
        _ptr(scores), _ptr(diffs), _ptr(alignlengths),
    )
    return scores, diffs, alignlengths


def qgram_profiles_arena(codes, offsets, lengths):
    """[n, 16] uint64 parity profiles from the offset-based arena."""
    n = len(offsets)
    profiles = np.zeros((max(n, 1), 16), dtype=np.uint64)
    lib.qgram_profiles_arena(
        _ptr(np.ascontiguousarray(codes, dtype=np.uint8)),
        _ptr(np.ascontiguousarray(offsets, dtype=np.int64)),
        _ptr(np.ascontiguousarray(lengths, dtype=np.int64)),
        ctypes.c_int64(n), profiles.ctypes.data_as(U64),
    )
    return profiles[:n]


def algo_cluster(profiles, codes, offsets, lengths, abundances, d,
                 mismatch, gapopen, gapextend, bit_mode,
                 no_break, want_structure):
    """Run the full d>=2 clustering loop natively (swarm_native.c:
    algo_cluster). Returns None if the native module is unavailable,
    else a dict with the final partition arrays, per-swarm stats, the
    join records (parent, child, diff, gen — in join order, which is
    also the uclust hit order), and the summary numbers."""
    n = len(offsets)
    order = np.arange(n, dtype=np.int64)
    diffest = np.zeros(n, dtype=np.int64)
    swarmid_arr = np.zeros(n, dtype=np.int64)
    gen_arr = np.zeros(n, dtype=np.int64)
    rad_arr = np.zeros(n, dtype=np.int64)
    cap = max(n, 1)
    swarm_seed = np.empty(cap, dtype=np.int64)
    swarm_size = np.empty(cap, dtype=np.int64)
    swarm_copies = np.empty(cap, dtype=np.int64)
    swarm_singletons = np.empty(cap, dtype=np.int64)
    swarm_maxgen = np.empty(cap, dtype=np.int64)
    swarm_maxrad = np.empty(cap, dtype=np.int64)
    swarm_bound = np.empty(cap, dtype=np.int64)
    struct_parent = np.empty(cap, dtype=np.int64)
    struct_child = np.empty(cap, dtype=np.int64)
    struct_diff = np.empty(cap, dtype=np.int64)
    struct_gen = np.empty(cap, dtype=np.int64)
    summary = np.zeros(6, dtype=np.int64)
    lib.algo_cluster.restype = ctypes.c_int64
    swarmcount = lib.algo_cluster(
        profiles.ctypes.data_as(U64),
        _ptr(np.ascontiguousarray(codes, dtype=np.uint8)),
        _ptr(np.ascontiguousarray(offsets, dtype=np.int64)),
        _ptr(np.ascontiguousarray(lengths, dtype=np.int64)),
        _ptr(np.ascontiguousarray(abundances, dtype=np.int64)),
        ctypes.c_int64(n), ctypes.c_int64(d),
        ctypes.c_int64(mismatch), ctypes.c_int64(gapopen),
        ctypes.c_int64(gapextend), ctypes.c_int64(bit_mode),
        ctypes.c_int(1 if no_break else 0),
        ctypes.c_int(1 if want_structure else 0),
        _ptr(order), _ptr(diffest), _ptr(swarmid_arr), _ptr(gen_arr),
        _ptr(rad_arr),
        _ptr(swarm_seed), _ptr(swarm_size), _ptr(swarm_copies),
        _ptr(swarm_singletons), _ptr(swarm_maxgen), _ptr(swarm_maxrad),
        _ptr(swarm_bound),
        _ptr(struct_parent), _ptr(struct_child), _ptr(struct_diff),
        _ptr(struct_gen), _ptr(summary),
    )
    if swarmcount < 0:
        raise MemoryError("algo_cluster")
    sc = int(swarmcount)
    nstruct = int(summary[2])
    return {
        "order": order, "swarmid": swarmid_arr, "gen": gen_arr,
        "rad": rad_arr,
        "swarm_seed": swarm_seed[:sc], "swarm_size": swarm_size[:sc],
        "swarm_copies": swarm_copies[:sc],
        "swarm_singletons": swarm_singletons[:sc],
        "swarm_maxgen": swarm_maxgen[:sc],
        "swarm_maxrad": swarm_maxrad[:sc],
        "swarm_bound": swarm_bound[:sc],
        "struct_parent": struct_parent[:nstruct],
        "struct_child": struct_child[:nstruct],
        "struct_diff": struct_diff[:nstruct],
        "struct_gen": struct_gen[:nstruct],
        "largest": int(summary[0]), "maxgen": int(summary[1]),
        "swarmcount": sc,
        "comparisons": {
            "gen1_screen": int(summary[3]),
            "subseed_scan": int(summary[4]),
            "alignments": int(summary[5]),
        },
    }


#: above this the probe engine's random table walks outgrow cache and
#: the sequential radix sort-join wins (measured crossover ~64k)
D1_HOST_SORTJOIN_MIN = 65536


def d1_network(codes, offsets, lengths, abundances, no_break, nthreads=1):
    """(edges_from, edges_to) for d=1 via the host constructions
    (swarm_native.c: d1_network_native / _mt / _sortjoin). Same
    contract as ops/neighbors.py:build_network. Engine choice:
    the bitset/probe one below D1_HOST_SORTJOIN_MIN amplicons
    (nthreads > 1 threads its probe phase), the cache-oblivious radix
    sort-join above (SWARM_TPU_D1_HOST=probe|sortjoin overrides);
    outputs are identical."""
    n = len(offsets)
    lib.d1_network_native.restype = ctypes.c_int64
    lib.d1_network_native_mt.restype = ctypes.c_int64
    lib.d1_network_sortjoin.restype = ctypes.c_int64
    mode = os.environ.get("SWARM_TPU_D1_HOST", "")
    use_sortjoin = mode == "sortjoin" or (
        mode != "probe" and n >= D1_HOST_SORTJOIN_MIN
    )
    cap = max(8 * n, 64)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    abundances = np.ascontiguousarray(abundances, dtype=np.int64)
    while True:
        ef = np.empty(cap, dtype=np.int64)
        et = np.empty(cap, dtype=np.int64)
        if use_sortjoin:
            cnt = lib.d1_network_sortjoin(
                _ptr(codes), _ptr(offsets), _ptr(lengths), ctypes.c_int64(n),
                _ptr(abundances), ctypes.c_int(1 if no_break else 0),
                _ptr(ef), _ptr(et), ctypes.c_int64(cap),
            )
        elif nthreads > 1:
            cnt = lib.d1_network_native_mt(
                _ptr(codes), _ptr(offsets), _ptr(lengths), ctypes.c_int64(n),
                _ptr(abundances), ctypes.c_int(1 if no_break else 0),
                ctypes.c_int64(nthreads),
                _ptr(ef), _ptr(et), ctypes.c_int64(cap),
            )
        else:
            cnt = lib.d1_network_native(
                _ptr(codes), _ptr(offsets), _ptr(lengths), ctypes.c_int64(n),
                _ptr(abundances), ctypes.c_int(1 if no_break else 0),
                _ptr(ef), _ptr(et), ctypes.c_int64(cap),
            )
        if cnt == -1:
            cap *= 2
            continue
        if cnt == -3:  # owner id space exceeded: probe engine instead
            use_sortjoin = False
            continue
        if cnt < 0:
            raise MemoryError("d1_network_native")
        return ef[:cnt], et[:cnt]


def d2_diffs_pairs(codes, offsets, lengths, abundances, pa, pb, d,
                   mismatch, gapopen, gapextend, no_break, nthreads=0):
    """Exact directed diffs for candidate pairs (swarm_native.c:
    d2_diffs_pairs): banded ideal-mode DP (8-bit / search8 semantics,
    reference src/search8.cc:629-903) with early row-minimum rejection.
    Returns (diff_ab, diff_ba): diff for query pa[i] -> target pb[i]
    when the abundance rule admits that direction and the accepted
    diff <= d, else -1."""
    P = len(pa)
    diff_ab = np.empty(max(P, 1), dtype=np.int64)
    diff_ba = np.empty(max(P, 1), dtype=np.int64)
    if P == 0:
        return diff_ab[:0], diff_ba[:0]
    if nthreads <= 0:
        nthreads = os.cpu_count() or 1
    pa = np.ascontiguousarray(pa, dtype=np.int64)
    pb = np.ascontiguousarray(pb, dtype=np.int64)
    lib.d2_diffs_pairs.restype = ctypes.c_int64
    rc = lib.d2_diffs_pairs(
        _ptr(np.ascontiguousarray(codes, dtype=np.uint8)),
        _ptr(np.ascontiguousarray(offsets, dtype=np.int64)),
        _ptr(np.ascontiguousarray(lengths, dtype=np.int64)),
        _ptr(np.ascontiguousarray(abundances, dtype=np.int64)),
        _ptr(pa), _ptr(pb), ctypes.c_int64(P),
        ctypes.c_int64(d), ctypes.c_int64(mismatch),
        ctypes.c_int64(gapopen), ctypes.c_int64(gapextend),
        ctypes.c_int(1 if no_break else 0), ctypes.c_int64(nthreads),
        _ptr(diff_ab), _ptr(diff_ba),
    )
    if rc < 0:
        raise MemoryError("d2_diffs_pairs")
    return diff_ab, diff_ba


def algo_cluster_graph(adj_start, adj_count, adj_to, adj_diff, abundances,
                       want_structure):
    """Graph-driven d>=2 clustering (swarm_native.c: algo_cluster_graph):
    identical outputs to algo_cluster, with candidate discovery from a
    precomputed directed adjacency (CSR, target ids ascending, per-edge
    accepted diff)."""
    n = len(adj_start)
    order = np.arange(n, dtype=np.int64)
    pos_of = np.arange(n, dtype=np.int64)
    swarmid_arr = np.zeros(n, dtype=np.int64)
    gen_arr = np.zeros(n, dtype=np.int64)
    rad_arr = np.zeros(n, dtype=np.int64)
    cap = max(n, 1)
    swarm_seed = np.empty(cap, dtype=np.int64)
    swarm_size = np.empty(cap, dtype=np.int64)
    swarm_copies = np.empty(cap, dtype=np.int64)
    swarm_singletons = np.empty(cap, dtype=np.int64)
    swarm_maxgen = np.empty(cap, dtype=np.int64)
    swarm_maxrad = np.empty(cap, dtype=np.int64)
    swarm_bound = np.empty(cap, dtype=np.int64)
    struct_parent = np.empty(cap, dtype=np.int64)
    struct_child = np.empty(cap, dtype=np.int64)
    struct_diff = np.empty(cap, dtype=np.int64)
    struct_gen = np.empty(cap, dtype=np.int64)
    summary = np.zeros(6, dtype=np.int64)
    lib.algo_cluster_graph.restype = ctypes.c_int64
    swarmcount = lib.algo_cluster_graph(
        _ptr(np.ascontiguousarray(adj_start, dtype=np.int64)),
        _ptr(np.ascontiguousarray(adj_count, dtype=np.int64)),
        _ptr(np.ascontiguousarray(adj_to, dtype=np.int64)),
        _ptr(np.ascontiguousarray(adj_diff, dtype=np.int64)),
        _ptr(np.ascontiguousarray(abundances, dtype=np.int64)),
        ctypes.c_int64(n),
        ctypes.c_int(1 if want_structure else 0),
        _ptr(order), _ptr(pos_of), _ptr(swarmid_arr), _ptr(gen_arr),
        _ptr(rad_arr),
        _ptr(swarm_seed), _ptr(swarm_size), _ptr(swarm_copies),
        _ptr(swarm_singletons), _ptr(swarm_maxgen), _ptr(swarm_maxrad),
        _ptr(swarm_bound),
        _ptr(struct_parent), _ptr(struct_child), _ptr(struct_diff),
        _ptr(struct_gen), _ptr(summary),
    )
    if swarmcount < 0:
        raise MemoryError("algo_cluster_graph")
    sc = int(swarmcount)
    nstruct = int(summary[2])
    return {
        "order": order, "swarmid": swarmid_arr, "gen": gen_arr,
        "rad": rad_arr,
        "swarm_seed": swarm_seed[:sc], "swarm_size": swarm_size[:sc],
        "swarm_copies": swarm_copies[:sc],
        "swarm_singletons": swarm_singletons[:sc],
        "swarm_maxgen": swarm_maxgen[:sc],
        "swarm_maxrad": swarm_maxrad[:sc],
        "swarm_bound": swarm_bound[:sc],
        "struct_parent": struct_parent[:nstruct],
        "struct_child": struct_child[:nstruct],
        "struct_diff": struct_diff[:nstruct],
        "struct_gen": struct_gen[:nstruct],
        "largest": int(summary[0]), "maxgen": int(summary[1]),
        "swarmcount": sc,
        "comparisons": {
            "gen1_screen": int(summary[3]),
            "subseed_scan": int(summary[4]),
            "alignments": int(summary[5]),
        },
    }


def verify_dist1_pairs(codes, offsets, lengths, pa, pb):
    """Exact dist<=1 check of candidate pairs against the code arena
    (host tail of the width-bucketed d=1 join)."""
    P = len(pa)
    good = np.zeros(P, dtype=np.uint8)
    lib.verify_dist1_pairs.restype = None
    lib.verify_dist1_pairs(
        _ptr(np.ascontiguousarray(codes, dtype=np.uint8)),
        _ptr(np.ascontiguousarray(offsets, dtype=np.int64)),
        _ptr(np.ascontiguousarray(lengths, dtype=np.int64)),
        _ptr(np.ascontiguousarray(pa, dtype=np.int64)),
        _ptr(np.ascontiguousarray(pb, dtype=np.int64)),
        ctypes.c_int64(P), _ptr(good),
    )
    return good.astype(bool)


#: packed-key budget of graft_join_native (2^28 metadata indices);
#: module-level so tests can shrink it to exercise the strip path
GRAFT_KEY_BUDGET = (1 << 28) - 1


def _graft_join_once(codes, offsets, lengths, n, heavy_ids, light_ids):
    lib.graft_join_native.restype = ctypes.c_int64
    graft_cand = np.full(n, -1, dtype=np.int64)
    cnt = lib.graft_join_native(
        _ptr(np.ascontiguousarray(codes, dtype=np.uint8)),
        _ptr(np.ascontiguousarray(offsets, dtype=np.int64)),
        _ptr(np.ascontiguousarray(lengths, dtype=np.int64)),
        ctypes.c_int64(n),
        _ptr(np.ascontiguousarray(heavy_ids, dtype=np.int64)),
        ctypes.c_int64(len(heavy_ids)),
        _ptr(np.ascontiguousarray(light_ids, dtype=np.int64)),
        ctypes.c_int64(len(light_ids)),
        _ptr(graft_cand),
    )
    if cnt == -3:
        return None
    if cnt < 0:
        raise MemoryError("graft_join_native")
    return int(cnt), graft_cand


def graft_probe_max_table_keys() -> int:
    """Table-side key ceiling for the asymmetric probe join: keeps the
    open-addressing table (2 x keys x 8 B) and bitset inside the cache
    hierarchy, where a probe costs nanoseconds; past it the radix
    sort-join's sequential passes win. SWARM_TPU_GRAFT_PROBE_MAX
    overrides it, read at each call. models/d1.py gives the graft to the
    device engine above it."""
    return int(os.environ.get("SWARM_TPU_GRAFT_PROBE_MAX", str(2 << 20)))


def _graft_probe_once(codes, offsets, lengths, n, heavy_ids, light_ids):
    lib.graft_probe_native.restype = ctypes.c_int64
    graft_cand = np.full(n, -1, dtype=np.int64)
    cnt = lib.graft_probe_native(
        _ptr(np.ascontiguousarray(codes, dtype=np.uint8)),
        _ptr(np.ascontiguousarray(offsets, dtype=np.int64)),
        _ptr(np.ascontiguousarray(lengths, dtype=np.int64)),
        ctypes.c_int64(n),
        _ptr(np.ascontiguousarray(heavy_ids, dtype=np.int64)),
        ctypes.c_int64(len(heavy_ids)),
        _ptr(np.ascontiguousarray(light_ids, dtype=np.int64)),
        ctypes.c_int64(len(light_ids)),
        _ptr(graft_cand),
    )
    if cnt == -3:
        return None
    if cnt < 0:
        raise MemoryError("graft_probe_native")
    return int(cnt), graft_cand


def graft_join(codes, offsets, lengths, n, heavy_ids, light_ids):
    """(count, graft_cand) — host graft join of both sides' canonical
    microvariant hashes with exact midpoint verification. Same contract
    as models/d1.py:_graft_join.

    Engine selection mirrors the device side: when one side's variant
    keys fit a cache-resident hash table, the asymmetric probe
    (swarm_native.c: graft_probe_native) tables it and streams the
    other side amplicon by amplicon — no big-side key array, no radix.
    Balanced sides use the radix sort-join (graft_join_native). Above
    the 2^28 packed-key budget the BIGGER side streams in strips (each
    pair lands in exactly one strip, so counts add and per-light minima
    merge); returns None only when even a minimal strip cannot fit
    (pathological lengths)."""
    lengths_arr = np.asarray(lengths)
    hk = int((7 * lengths_arr[np.asarray(heavy_ids, dtype=np.int64)] + 4).sum())
    lk = int((7 * lengths_arr[np.asarray(light_ids, dtype=np.int64)] + 4).sum())
    if 0 < min(hk, lk) <= graft_probe_max_table_keys():
        res = _graft_probe_once(codes, offsets, lengths, n, heavy_ids, light_ids)
        if res is not None:
            return res

    res = _graft_join_once(codes, offsets, lengths, n, heavy_ids, light_ids)
    if res is not None:
        return res

    heavy_ids = np.ascontiguousarray(heavy_ids, dtype=np.int64)
    light_ids = np.ascontiguousarray(light_ids, dtype=np.int64)
    lengths_arr = np.asarray(lengths)
    big_is_heavy = len(heavy_ids) > len(light_ids)
    big = heavy_ids if big_is_heavy else light_ids
    small = light_ids if big_is_heavy else heavy_ids

    budget = GRAFT_KEY_BUDGET
    small_keys = int((7 * lengths_arr[small] + 4).sum())
    strip_budget = budget - small_keys
    big_keys = 7 * lengths_arr[big].astype(np.int64) + 4
    if len(big) == 0 or strip_budget < int(big_keys.max()):
        return None  # cannot stream: the small side alone overflows
    cum = np.cumsum(big_keys)

    total = 0
    graft_cand = np.full(n, -1, dtype=np.int64)
    start = 0
    while start < len(big):
        base = cum[start - 1] if start else 0
        end = int(np.searchsorted(cum, base + strip_budget, side="right"))
        end = max(end, start + 1)
        strip = big[start:end]
        if big_is_heavy:
            res = _graft_join_once(codes, offsets, lengths, n, strip, small)
        else:
            res = _graft_join_once(codes, offsets, lengths, n, small, strip)
        if res is None:
            return None
        cnt, cand = res
        total += cnt
        both = (graft_cand >= 0) & (cand >= 0)
        graft_cand = np.where(
            both, np.minimum(graft_cand, cand),
            np.where(cand >= 0, cand, graft_cand),
        )
        start = end
    return total, graft_cand
