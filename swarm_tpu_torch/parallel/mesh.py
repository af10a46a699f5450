"""The sharded engines: the d=1 network, -f's graft and the d>=2 screen
over shards.

Counterpart of swarm_tpu/parallel/mesh.py (SortJoinShardedEngine, its
body _sharded_join_body; ShardedGraftEngine, its body
_sharded_graft_body with _shard_variant_keys and _route_blocks) and of
the sharded screen of swarm_tpu/ops/d2_network.py
(sharded_screen_extract, D2NetworkEngine.candidate_pairs_sharded).
swarm_tpu's bodies are XLA programs; here every shard runs the port's
hand kernels on its share (d1_keygen, d1_partition, d1_join, d1_verify;
graft_keygen, graft_join, graft_verify; d2_screen, d2_extract), and an
exchange moves the keys between shards. The wrappers launch their
kernels on a CUDA tensor or raise: no plain version serves the card.

- Split: a side's rows are split into contiguous shares by key count,
  not by row count (key_split; the rows are ragged, so an even split of
  rows would load a shard of long reads more). Each shard emits the keys
  of its share with global owners (d=1: the share's first row added) or
  payloads (graft: the share's first key added). The packed code rows
  are replicated: every shard holds the whole arena, one copy a device.
- Route: a key goes to the shard that owns its global bucket
  bucket_of(key, B), B = bucket_bits of the keys in all; shard j of k
  owns the contiguous buckets bucket_range(j, k, B). One d1_partition at
  B bits gives every destination's contiguous range (route_sizes: one
  readback of the bucket ends at the k boundaries); the receiver
  partitions what it got at the same B bits and joins all its bucket
  ends (the buckets outside its own are empty). Equal keys share a
  bucket, so every two equal keys meet on one shard, and each candidate
  is found as often as on one device. B and the splits come from counts
  that every shard computes alike; across ranks Shards.agree checks them
  before the first exchange.
- Gather: the d=1 shards' verified pairs are gathered onto the first
  shard's device and deduplicated there (a pair found through two
  different keys lies on two shards), then finished on the host as the
  single-device engine does; the graft's
  smallest heavy amplicon of each light one is reduced by min, its
  count by sum; the d>=2 shards take contiguous ranges of the tile-pair
  steps, and their pairs, gathered in shard order, are the steps' order.

No caps, windows or retries (swarm_tpu's block_over, cap, cap2,
window): sizes come from count passes and one readback an exchange.

Shards (the base of LocalShards here and distributed.RankShards) is
what an engine needs of its shards: their devices and three
collectives, each entered by every shard, also with nothing to move.
Each engine's phases are spans of the run's record (metrics.py), named
ENGINE_shards.PHASE (ENGINE: d1, graft, d2), each over this process'
shards, the exchanges among them (ENGINE_shards.exchange); its counters
ENGINE_shards.count (the shards of its last run in the record: set, not
summed), .exchanges and .exchange_bytes (what this process received,
summed). No span synchronises a device. With
SWARM_TPU_TIMING set an engine writes a `[timing] ENGINE shards K
(DEVICE)` line a phase from its spans when it ends.
"""

import os

import numpy as np
import torch

from .. import _native, metrics
from ..ops import d2_network as d2n
from ..ops import fastidious_torch as ft
from ..ops import neighbors_sortjoin as sj

_INT32_MAX = (1 << 31) - 1

#: each engine's phases, in the order it runs them: its spans
#: ENGINE_shards.PHASE and its [timing] lines
PHASES = {"d1": ("start", "split", "emit", "route", "exchange", "partition",
                 "join", "verify", "gather", "finish"),
          "graft": ("count", "split", "emit", "route", "exchange",
                    "partition", "join", "verify", "gather"),
          "d2": ("screen", "extract", "gather")}


class Shards:
    """The shards of an engine's work that this process owns: `count`
    in all, this process' `owned` (global indices, ascending), and the
    device of each owned shard (`devices`).

    - exchange(sends): sends[i] = (tensors, sizes) of owned shard i, a
      tuple of equally long 1-D tensors whose first sizes[0] elements go
      to shard 0, the next sizes[1] to shard 1 and so on; returns
      (received, got): received[i] the tuple of tensors that owned
      shard i got, the sources' parts concatenated in shard order on
      its device, got[i] the elements from each source;
    - gather(tensors): one 1-D tensor an owned shard, of one dtype;
      every shard's concatenated in shard order, on the first owned
      shard's device;
    - reduce(tensors, op): one tensor an owned shard, of one shape;
      their elementwise "min" or "sum" over every shard, on the CPU.
    """

    count = 1
    owned = [0]
    devices = []

    def exchange(self, sends):
        raise NotImplementedError

    def gather(self, tensors):
        raise NotImplementedError

    def reduce(self, tensors, op: str):
        raise NotImplementedError

    def replicas(self):
        """The distinct devices of the owned shards, in shard order."""
        return list(dict.fromkeys(self.devices))

    def first_on(self, device) -> int:
        """The owned index of the first shard on `device`."""
        return self.devices.index(device)

    def agree(self, values):
        """Raise unless every shard holds the same integers `values`
        (a gather and a readback)."""
        mine = torch.tensor(values, dtype=torch.int64)
        got = self.gather([mine.to(dev) for dev in self.devices]).cpu() \
            .reshape(self.count, len(values))
        if bool((got != got[0]).any()):
            raise RuntimeError(f"the shards disagree on {values}: "
                               f"{got.tolist()}")


class LocalShards(Shards):
    """`count` shards in this process: shard i on cuda:(i %
    device_count) for a CUDA `device`, every shard on `device`
    otherwise. The exchange copies each part to its receiver's device
    (an ordered copy against both devices' current streams) and
    concatenates the parts there."""

    def __init__(self, count: int, device):
        device = torch.device(device)
        self.count = int(count)
        self.owned = list(range(self.count))
        if device.type == "cuda":
            n_dev = torch.cuda.device_count()
            self.devices = [torch.device("cuda", i % n_dev)
                            for i in range(self.count)]
        else:
            self.devices = [device] * self.count

    def agree(self, values):
        """Nothing to check: the shards of one process read one list."""

    def exchange(self, sends):
        starts = [np.cumsum([0, *sizes]) for _, sizes in sends]
        received, got = [], []
        for j, dev in enumerate(self.devices):
            parts = [[t[s[j]:s[j + 1]].to(dev) for t in tensors]
                     for (tensors, _), s in zip(sends, starts)]
            received.append(tuple(torch.cat(col) for col in zip(*parts)))
            got.append([int(s[j + 1] - s[j]) for s in starts])
        return received, got

    def gather(self, tensors):
        dev = self.devices[0]
        return torch.cat([t.to(dev) for t in tensors])

    def reduce(self, tensors, op: str):
        dev = tensors[0].device
        out = tensors[0]
        for t in tensors[1:]:
            out = torch.minimum(out, t.to(dev)) if op == "min" \
                else out + t.to(dev)
        return out.cpu()


def bucket_range(j: int, k: int, bits: int):
    """The buckets [lo, hi) of a partition at `bits` bits that shard j
    of k owns: contiguous, every bucket owned once (a shard may own
    none when 2^bits < k)."""
    return (j << bits) // k, ((j + 1) << bits) // k


def route_sizes(bucket_ends, k: int, bits: int):
    """[k] ints: the elements of keys partitioned at `bits` bits
    (bucket_ends, inclusive) that go to each shard; one readback."""
    edges = [bucket_range(j, k, bits)[0] for j in range(k)] + [1 << bits]
    idx = torch.tensor([max(e - 1, 0) for e in edges],
                       device=bucket_ends.device)
    at = [v if e else 0 for v, e in zip(bucket_ends[idx].tolist(), edges)]
    return [at[j + 1] - at[j] for j in range(k)]


def key_split(ends, k: int):
    """(rows, keys): the boundaries 0 = r_0 <= ... <= r_k = n of k
    contiguous shares of rows of about total / k keys each, `ends` being
    the inclusive int64 cumsum of the rows' key counts (a tensor), and
    the keys before each boundary. One readback (two for k > 1)."""
    n = ends.numel()
    total = int(ends[-1]) if n else 0
    if k == 1 or n == 0:
        return [0] * k + [n], [0] * k + [total]
    targets = torch.tensor([j * total // k for j in range(1, k)],
                           dtype=torch.int64, device=ends.device)
    r = torch.searchsorted(ends, targets, right=True)
    base = torch.where(r > 0, ends[(r - 1).clamp(min=0)],
                       torch.zeros_like(r))
    r, base = torch.stack([r, base]).tolist()
    return [0, *r, n], [0, *base, total]


def _phase(engine, phase):
    """The span of one phase of `engine` (PHASES) on this process'
    shards."""
    return metrics.span(f"{engine}_shards.{phase}")


def _exchange(engine, shards, sends):
    """shards.exchange(sends)'s received tensors, in the span
    ENGINE_shards.exchange, counted with the bytes they hold."""
    with _phase(engine, "exchange"):
        received, got = shards.exchange(sends)
    metrics.record(**{
        f"{engine}_shards.exchanges": 1,
        f"{engine}_shards.exchange_bytes": sum(
            sum(sizes) * sum(t.element_size() for t in tensors)
            for tensors, sizes in zip(received, got))})
    return received


def _report(engine, shards):
    """Set the shard count of `engine`'s run (an engine that runs twice
    in one run still reads `shards.count`) and write its [timing] lines
    (metrics.timing) from its spans."""
    metrics.last_run[f"{engine}_shards.count"] = shards.count
    metrics.timing(
        f"{engine} shards {shards.count} ({shards.devices[0].type})",
        metrics.step_seconds(f"{engine}_shards", PHASES[engine]))


def _empty(dtype, dev):
    return torch.zeros(0, dtype=dtype, device=dev)


class SortJoinShardedEngine:
    """The d=1 network (SortJoinNeighborEngine's contract) over
    `shards`, for rows of any mix of lengths.

    start() copies the arena to each shard device and enqueues the
    keygen's count and pack pass there (the whole arena, replicated);
    build_network() splits the rows by key count, and each shard emits
    its keys, routes them (d1_partition, the exchange), partitions what
    it received, joins its buckets, deduplicates and verifies against
    the replicated rows; the verified pairs are gathered and deduplicated
    on the first shard's device, and finished on the host. `packed_rows`
    then holds each device's (words, row_word, lengths), for -f's
    sharded graft.
    """

    def __init__(self, db, shards):
        self.db = db
        self.n = len(db)
        self.shards = shards
        self._replicas = None  # device -> (words, row_word, lengths, ends)
        #: device -> (words, row_word, lengths) once build_network ran
        self.packed_rows = None

    def start(self) -> None:
        """Copy the arena to every shard device and enqueue the count
        and pack pass, so that the devices work while the host checks
        for duplicates."""
        if self.n == 0 or self._replicas is not None:
            return
        reps = {}
        with _phase("d1", "start"):
            for dev in self.shards.replicas():
                codes, offsets, lengths, row_word, n_words = \
                    sj.SortJoinNeighborEngine(self.db, dev).arena()
                counts, words = sj.keygen_count(codes, offsets, lengths,
                                                row_word, n_words)
                reps[dev] = (words, row_word, lengths,
                             torch.cumsum(counts, 0, dtype=torch.int64))
        self._replicas = reps

    def build_network(self, no_break: bool, abundances: np.ndarray):
        """(edges_from, edges_to) as SortJoinNeighborEngine gives them."""
        if self.n == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
        self.start()
        reps, self._replicas = self._replicas, None
        self.packed_rows = {dev: r[:3] for dev, r in reps.items()}
        sh = self.shards
        k = sh.count
        with _phase("d1", "split"):
            rows, keys = key_split(reps[sh.devices[0]][3], k)
            bits = sj.bucket_bits(keys[-1])
            sh.agree([self.n, keys[-1], bits])
            row_word, n_words = sj.ragged_layout(self.db.lengths)
            word_at = np.append(row_word, n_words)  # row a's first word

        sends = []
        for i, j in enumerate(sh.owned):
            words, rw, lengths, ends = reps[sh.devices[i]]
            a, b, k0 = rows[j], rows[j + 1], keys[j]
            w0 = int(word_at[a])
            with _phase("d1", "emit"):
                kk, ow = sj.keygen_emit(words[w0:int(word_at[b])],
                                        rw[a:b] - w0, lengths[a:b],
                                        ends[a:b] - k0, keys[j + 1] - k0)
                if a:
                    ow += a
            with _phase("d1", "route"):
                kk, ow, be = sj.partition(kk, ow, bits)
                sends.append(((kk, ow), route_sizes(be, k, bits)))
            del kk, ow, be
        received = _exchange("d1", sh, sends)
        del sends

        good, n_cand = [], []
        for i in range(len(sh.owned)):
            dev = sh.devices[i]
            words, rw, lengths, _ = reps[dev]
            kk, ow = received[i]
            received[i] = None
            cand = _empty(torch.int64, dev)
            if kk.numel():
                with _phase("d1", "partition"):
                    kk, ow, be = sj.partition(kk, ow, bits)
                with _phase("d1", "join"):
                    cand = sj.join_pairs(kk, ow, be)
            del kk, ow
            with _phase("d1", "verify"):
                uniq = torch.unique_consecutive(torch.sort(cand).values)
                good.append(uniq[sj.verify_pairs(words, rw, lengths, uniq)])
                n_cand.append(torch.tensor([cand.numel()], device=dev))
            del cand, uniq
        with _phase("d1", "gather"):
            # deduplicated on the device: numpy's unique of d1_1m's
            # 484,016 pairs takes 0.22-0.44 s on an H100's host,
            # torch.unique and the copy 1 ms (scripts/dedup_probe.py)
            pairs = torch.unique(sh.gather(good)).cpu().numpy()
            comparisons = int(sh.reduce(n_cand, "sum")[0])
        metrics.record(d1_join_comparisons=comparisons)
        with _phase("d1", "finish"):
            # unique verified pairs a < b: both directions, the
            # abundance rule, sorted by (from, to)
            ef, et = _native.d1_finish_edges(
                pairs >> 32, pairs & sj.MASK32,
                np.asarray(abundances, np.int64), no_break)
        _report("d1", sh)
        return ef, et


class ShardedGraftEngine:
    """-f's graft candidates (GraftEngine's contract) over `shards`.

    Every shard counts the keys of both whole sides (keygen_count: their
    global ends), then emits the keys of its contiguous key range of the
    smaller side with global payloads, routes them and keeps what it
    received, partitioned. The bigger side goes in strips (GraftEngine's
    budget, over the shards' devices), each split, emitted, routed and
    partitioned the same way; each shard joins its buckets and verifies
    the pairs against the whole sides' ids and ends, lowering its own
    copy of each light amplicon's smallest heavy one. The copies are
    reduced by min, the counts by sum: a midpoint's key lives on one
    shard, so each verified triple is counted once. `rows`: each
    device's packed rows that the d=1 engine left, or None.
    """

    #: keys a strip of the bigger side holds at most over all shards;
    #: None: from the free device memory (_strip_keys), on the CPU
    #: GraftEngine's CPU_STRIP_KEYS
    MAX_STRIP_KEYS = None

    def __init__(self, db, shards, rows=None):
        self.db = db
        self.n = len(db)
        self.shards = shards
        self._rows = dict(rows or {})

    def packed_rows(self, dev):
        """(words, row_word, lengths) of every row on `dev`."""
        if dev not in self._rows:
            self._rows[dev] = ft.GraftEngine(self.db, dev).packed_rows()
        return self._rows[dev]

    def _strip_keys(self, small_keys: int) -> int:
        """The budget of a strip: GraftEngine's 24 bytes a key of half
        the free memory, less the small side's keys, for each device,
        over the shards on it, at 36 bytes a key (a strip's sent keys
        and payloads stay while it receives); the least over the
        devices and ranks."""
        sh = self.shards
        if self.MAX_STRIP_KEYS is not None:
            return self.MAX_STRIP_KEYS
        if sh.devices[0].type == "cpu":
            return ft.GraftEngine.CPU_STRIP_KEYS
        budgets = []
        for dev in sh.devices:
            on = sh.devices.count(dev)
            free, _ = torch.cuda.mem_get_info(dev)
            mine = free // 2 - 24 * small_keys * on // sh.count
            budgets.append(torch.tensor(
                [max(1, mine // 36 * sh.count // on)], device=dev))
        return min(_INT32_MAX, int(sh.reduce(budgets, "min")[0]))

    def _emit(self, side, ids, ends, share):
        """The keys and global payloads of rows ids[a:b] (`share` (a, b,
        k0, k1): their first key is k0 of the side or strip, ends its
        inclusive cumsum)."""
        words, row_word, lengths, zob = side
        a, b, k0, k1 = share
        kk, pp = ft.keygen_emit(words, row_word, lengths, ids[a:b], zob,
                                ends[a:b] - k0, k1 - k0)
        if k0:
            pp += k0
        return kk, pp

    def _route(self, bits, sides, parts):
        """Emit, partition and exchange the shares: parts[i] = (ids,
        ends, rows, keys) of owned shard i; returns each shard's keys and
        payloads, partitioned, with their bucket ends."""
        sh = self.shards
        sends = []
        for i, j in enumerate(sh.owned):
            ids, ends, rows, keys = parts[i]
            with _phase("graft", "emit"):
                kk, pp = self._emit(sides[sh.devices[i]], ids, ends,
                                    (rows[j], rows[j + 1], keys[j],
                                     keys[j + 1]))
            with _phase("graft", "route"):
                kk, pp, be = sj.partition(kk, pp, bits)
                sends.append(((kk, pp), route_sizes(be, sh.count, bits)))
            del kk, pp, be
        received = _exchange("graft", sh, sends)
        del sends
        out = []
        for i in range(len(sh.owned)):
            kk, pp = received[i]
            received[i] = None
            with _phase("graft", "partition"):
                out.append(sj.partition(kk, pp, bits))
        return out

    def graft_candidates(self, heavy_amps: np.ndarray,
                         light_amps: np.ndarray):
        """(count, graft_cand [n] int64, -1 where none)."""
        graft_cand = np.full(self.n, -1, dtype=np.int64)
        if len(heavy_amps) == 0 or len(light_amps) == 0:
            return 0, graft_cand
        sh = self.shards
        lens = np.asarray(self.db.lengths, dtype=np.int64)
        zob = ft.make_zobrist_pair(max(int(lens.max()), 1))
        heavy = np.asarray(heavy_amps, dtype=np.int64)
        light = np.asarray(light_amps, dtype=np.int64)
        small_is_heavy = (7 * lens[heavy] + 4).sum() <= \
            (7 * lens[light] + 4).sum()
        small, big = (heavy, light) if small_is_heavy else (light, heavy)

        sides, ids = {}, {}
        with _phase("graft", "count"):
            for dev in sh.replicas():
                words, row_word, lengths = self.packed_rows(dev)
                sides[dev] = (words, row_word, lengths,
                              ft.zobrist_tensor(zob, dev))
                s_ids = torch.from_numpy(small).to(dev)
                b_ids = torch.from_numpy(big).to(dev)
                s_ends, b_ends = (torch.cumsum(
                    ft.keygen_count(words, row_word, lengths, x), 0,
                    dtype=torch.int64) for x in (s_ids, b_ids))
                ids[dev] = (s_ids, s_ends, b_ids, b_ends)
        with _phase("graft", "split"):
            dev0 = sh.devices[0]
            b_cum = np.concatenate([[0], ids[dev0][3].cpu().numpy()])
            b_counts = np.diff(b_cum)
            s_rows, s_keys = key_split(ids[dev0][1], sh.count)
            s_total = s_keys[-1]
            if s_total > _INT32_MAX:
                raise ValueError("the smaller side has 2^31 keys or more")
            strips = ft._strips(b_counts, self._strip_keys(s_total))
            bits = sj.bucket_bits(s_total + max(
                int(b_cum[b] - b_cum[a]) for a, b in strips))
            sh.agree([self.n, len(small), len(big), s_total, int(b_cum[-1]),
                      len(strips), bits])

        mine = self._route(bits, sides, [
            (ids[dev][0], ids[dev][1], s_rows, s_keys) for dev in sh.devices])
        best = [torch.full((self.n,), _INT32_MAX, dtype=torch.int32,
                           device=dev) for dev in sh.devices]
        count = [torch.zeros(1, dtype=torch.int64, device=dev)
                 for dev in sh.devices]
        for a, b in strips:
            base = int(b_cum[a])
            with _phase("graft", "split"):
                rows, keys = key_split(
                    torch.from_numpy(b_cum[a + 1:b + 1] - base), sh.count)
                strip = {dev: (ids[dev][2][a:b], ids[dev][3][a:b] - base)
                         for dev in sh.replicas()}
            theirs = self._route(bits, sides, [
                (*strip[dev], rows, keys) for dev in sh.devices])
            for i in range(len(sh.owned)):
                dev = sh.devices[i]
                skeys, spays, s_be = mine[i]
                bkeys, bpays, b_be = theirs[i]
                theirs[i] = None
                if skeys.numel() and bkeys.numel():
                    with _phase("graft", "join"):
                        pairs = ft.join_pairs(skeys, spays, s_be, bkeys,
                                              bpays, b_be)
                    del bkeys, bpays, b_be
                    words, row_word, lengths, _ = sides[dev]
                    with _phase("graft", "verify"):
                        ok = ft.verify(words, row_word, lengths, ids[dev][0],
                                       ids[dev][1], *strip[dev], pairs,
                                       small_is_heavy, best[i])
                        count[i] += ok.sum()
                    del pairs, ok
        with _phase("graft", "gather"):
            best = sh.reduce(best, "min").numpy()
            total = int(sh.reduce(count, "sum")[0])
        graft_cand = np.where(best == _INT32_MAX, -1, best.astype(np.int64))
        _report("graft", sh)
        return total, graft_cand


def sharded_candidate_pairs(engine, shards):
    """(ga, gb) of engine.candidate_pairs_device (a D2NetworkEngine)
    over `shards`: shard j of k screens and extracts the contiguous
    tile-pair steps [j K / k, (j + 1) K / k) of the K steps, in chunks
    of SWARM_TPU_D2_CHUNK, with the profiles replicated (one copy a
    device); the pairs, gathered in shard order onto the engine's
    device, come in the steps' order. The run's spans d2_network.screen
    and .to_host (the gather) hold the two parts, d2_shards.screen,
    .extract and .gather the shards' steps."""
    T = engine.TILE
    all_ti, all_tj = d2n.tile_steps(engine.n_pad // T)
    K = len(all_ti)
    C = max(1, int(os.environ.get("SWARM_TPU_D2_CHUNK", "512")))
    ga_parts, gb_parts = [], []
    with metrics.span("d2_network.screen"):
        profiles = {dev: (engine.prof.to(dev), engine.lengths.to(dev))
                    for dev in shards.replicas()}
        for i, j in enumerate(shards.owned):
            dev = shards.devices[i]
            prof, lengths = profiles[dev]
            ga_j = [_empty(torch.int32, dev)]
            gb_j = [_empty(torch.int32, dev)]
            s1 = (j + 1) * K // shards.count
            for c0 in range(j * K // shards.count, s1, C):
                tis = torch.from_numpy(all_ti[c0:min(c0 + C, s1)]).to(dev)
                tjs = torch.from_numpy(all_tj[c0:min(c0 + C, s1)]).to(dev)
                with _phase("d2", "screen"):
                    words, counts = d2n.screen_words(
                        prof, lengths, tis, tjs, T, engine.n, engine.d)
                with _phase("d2", "extract"):
                    ga, gb = d2n.extract_pairs(words, counts, tis, tjs, T)
                del words, counts
                ga_j.append(ga)
                gb_j.append(gb)
            ga_parts.append(torch.cat(ga_j))
            gb_parts.append(torch.cat(gb_j))
    with metrics.span("d2_network.to_host"), _phase("d2", "gather"):
        ga = shards.gather(ga_parts).to(engine.device)
        gb = shards.gather(gb_parts).to(engine.device)
    _report("d2", shards)
    return ga, gb
