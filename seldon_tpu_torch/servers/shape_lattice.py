"""Static shape lattice — port of ``seldon_tpu/servers/shape_lattice.py``,
line for line: the closed-form model of every static-shape key the
engine can dispatch.

The engine names each dispatch of a device family by a static-shape
tuple (family tag + bucket / padded-group / resident-width components —
the CompileLedger key), the key the JAX engine compiles one jit variant
for. In the port the converged engine's keys (``("ragged", C)``,
``("deactivate",)``) are captured programs on a single-rank engine's
kernel and masked legs (``servers/wave_program.py``: CUDA graphs, one
per host-side branch of a key); every other key is the shape class of
one eager dispatch. Consumers need the SAME answer to
"which keys exist for this config":

 * ``InferenceEngine.warmup()`` iterates :func:`dispatch_keys` and
   dispatches (or captures) each key once, so the compile ledger's
   declared set is exactly what live traffic can reach — a key outside
   it is a live retrace;
 * :func:`check_spec` cross-checks this closed form against
   :func:`simulate_keys`, an independent operational enumeration of the
   scheduler arithmetic, over :func:`grid` — a key the simulation
   reaches that the closed form misses is a statically proven live
   retrace;
 * ``InferenceEngine.static_lattice()`` renders the set, so a test can
   assert that every key a warmed engine dispatched lies inside it.

Pure host math over ``int``s — no torch import. Every formula mirrors a
named scheduler site in ``servers/engine.py``; the keys are the JAX
engine's, spelled the same, so the JAX module and this one give equal
sets for every spec.

Reachability facts the closed form encodes (each with its engine site):

 * prompts longer than ``max(buckets)`` are rejected at ``submit()``,
   so every live suffix/width bucket is in the bucket tuple — including
   ``max(buckets) == max_seq_len`` when the top bucket fills the cache
   window (``_bucket`` only falls through to ``max_seq_len`` for
   lengths above every bucket, which submit() forbids);
 * prefix matches are trie-block aligned (``prefix_block``) and capped
   at ``plen - 1``, so a (prefix bucket, suffix bucket) pair is live
   only if its minimum block-aligned prefix plus minimum suffix fit in
   one admissible prompt;
 * chunk groups are budget-bound: ``_collect_chunk_work`` subtracts
   each row's chunk bucket from the dispatch token budget, so a
   same-``Sc`` run never exceeds ``budget // Sc`` rows (then pads to
   the next power of two);
 * chunk resident widths are ``bucket(start)`` where ``start`` walks
   ``prefix_len + k * prefill_chunk`` — without a prefix cache only the
   ``k * prefill_chunk`` rungs exist;
 * copy-on-write block copies need a *shared* block, and blocks are
   only ever shared through the paged prefix trie, so ``("cow",)``
   exists only under paged + prefix.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import FrozenSet, List, Sequence, Set, Tuple

Key = Tuple[object, ...]

# Family tag -> full key tuple length (tag included), one entry per
# ``_note_dispatch`` key family in servers/engine.py. A new dispatch
# family must register here (and in dispatch_keys / simulate_keys)
# before it can land.
FAMILIES = {
    "deactivate": 1,     # lifecycle-reap freeze, one masked write
    "admit": 3,          # (tag, suffix bucket, padded group)
    "admit-prefix": 4,   # (tag, prefix bucket, suffix bucket, group)
    "admit-paged": 4,    # (tag, suffix bucket, group, prefix width)
    "chunk": 4,          # (tag, chunk bucket, group, resident width)
    "seed-prefix": 2,    # (tag, prefix width)
    "cow": 1,            # copy-on-write block copy (traced scalars)
    "decode": 2,         # (tag, chunk-ladder rung)
    "ragged": 2,         # (tag, per-slot chunk capacity) — the ONE wave
    "draft": 2,          # (tag, spec rung k) — draft-model proposal
    "verify": 2,         # (tag, spec rung k) — the wide verify wave
}


@dataclasses.dataclass(frozen=True)
class LatticeSpec:
    """The shape-relevant slice of an engine's config — everything the
    variant lattice depends on and nothing else.  Built by
    ``InferenceEngine.lattice_spec()``; constructed directly in tests
    and in the certifier's config grid."""

    buckets: Tuple[int, ...]        # ascending, clamped <= max_seq_len
    max_seq_len: int
    max_slots: int
    max_admit: int                  # engine _max_admit (power of two)
    decode_rungs: Tuple[int, ...]   # engine _chunk_sizes
    paged: bool = False
    chunked: bool = False
    prefix: bool = False            # any prefix index (dense or paged)
    prefix_block: int = 16
    chunk_buckets: Tuple[int, ...] = ()   # engine _chunk_buckets
    prefill_chunk: int = 0          # engine _prefill_chunk (clamped C)
    token_budget: int = 0           # dispatch_token_budget or C
    # graftragged (models/ragged_attention.py): every scheduler wave is
    # ONE fused kernel of fixed shape [max_slots, ragged_chunk] —
    # bucketing, pow2 grouping, decode rungs and the whole admit/chunk
    # key space collapse to the single ("ragged", C) variant.
    ragged: bool = False
    ragged_chunk: int = 0           # engine _ragged_chunk (per-slot C)
    # graftspec (models/spec_decode.py): the decode chunk ladder never
    # dispatches — one ("verify", k) rung per pow2 k replaces it, plus
    # the ("draft", k) ladder when a draft checkpoint is resident.
    # Admission families are untouched (spec only changes the decode
    # leg of each boundary).
    spec: bool = False
    spec_rungs: Tuple[int, ...] = ()  # engine _spec_rungs (pow2 1..k)
    spec_draft: bool = False        # draft-model ladder exists

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("buckets must be non-empty")
        if tuple(sorted(self.buckets)) != tuple(self.buckets):
            raise ValueError(f"buckets must ascend: {self.buckets}")
        if self.chunked and (not self.chunk_buckets
                             or self.prefill_chunk <= 0
                             or self.token_budget < self.prefill_chunk):
            raise ValueError(
                "chunked spec needs chunk_buckets, prefill_chunk and a "
                "token_budget >= prefill_chunk (EngineConfig validates "
                "the same)"
            )
        if self.ragged and (not self.paged or not self.chunked
                            or self.ragged_chunk <= 0):
            raise ValueError(
                "ragged spec needs paged + chunked engines and a "
                "positive ragged_chunk (EngineConfig validates the same)"
            )
        if self.spec:
            if not self.paged or self.ragged:
                raise ValueError(
                    "spec needs the paged engine and excludes ragged — "
                    "each replaces the decode dispatch (EngineConfig "
                    "validates the same)"
                )
            if not self.spec_rungs or any(
                kk <= 0 or kk & (kk - 1) for kk in self.spec_rungs
            ):
                raise ValueError(
                    f"spec_rungs must be non-empty powers of two: "
                    f"{self.spec_rungs!r}"
                )


def pow2ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _bucket(buckets: Sequence[int], smax: int, n: int) -> int:
    """engine._bucket: first bucket >= n, else the cache window."""
    for b in buckets:
        if n <= b:
            return b
    return smax


def _chunk_bucket(cbs: Sequence[int], n: int) -> int:
    """engine._chunk_bucket: first chunk rung >= n, else the top rung."""
    for b in cbs:
        if n <= b:
            return b
    return cbs[-1]


def _prev(rungs: Sequence[int], b: int) -> int:
    """The rung below `b` (0 below the first) — the largest length that
    does NOT bucket to `b`."""
    i = list(rungs).index(b)
    return rungs[i - 1] if i else 0


def _align_up(n: int, block: int) -> int:
    return -(-n // block) * block


def _min_prefix(spec: LatticeSpec, pb: int) -> int:
    """Shortest block-aligned prefix length that buckets to `pb`, or a
    value > pb when no aligned length lands in the bucket (then `pb` is
    unreachable as a prefix/width bucket)."""
    lo = _align_up(_prev(spec.buckets, pb) + 1, spec.prefix_block)
    return max(lo, spec.prefix_block)


def _group_rungs(gmax: int) -> List[int]:
    """Padded group sizes produced by groups of 1..gmax rows: the
    engine pads to the next power of two (duplicating the tail row), so
    the padded domain tops out at pow2ceil(gmax), not gmax."""
    out, g = [], 1
    top = pow2ceil(max(1, gmax))
    while g <= top:
        out.append(g)
        g *= 2
    return out


def _chunk_starts(spec: LatticeSpec) -> List[int]:
    """Every chunk start offset live scheduling can produce: chunk k of
    a request resumes at prefix_len + k * prefill_chunk, where
    prefix_len is 0 (cold) or a trie-block multiple (warm).  Bounded by
    max prompt - 1 (the final chunk covers at least one token)."""
    maxp = max(spec.buckets)
    c = spec.prefill_chunk
    starts: Set[int] = set()
    p0s = [0]
    if spec.prefix:
        p0s += list(range(spec.prefix_block, maxp, spec.prefix_block))
    for p0 in p0s:
        s = p0
        while s <= maxp - 1:
            starts.add(s)
            s += c
    return sorted(starts)


def dispatch_keys(spec: LatticeSpec) -> Set[Key]:
    """The closed-form lattice: every static-shape key live scheduling
    can dispatch under `spec`.  warmup() dispatches exactly this set."""
    maxp = max(spec.buckets)
    if spec.ragged:
        # graftragged: the whole admit/chunk/decode key space is ONE
        # fixed-shape wave — the lattice is the lifecycle freeze plus
        # the wave itself (plus the traced-scalar CoW copy when the
        # paged prefix trie can share a partially-filled block).
        keys = {("deactivate",), ("ragged", spec.ragged_chunk)}
        if spec.prefix:
            keys.add(("cow",))
        return keys
    keys: Set[Key] = {("deactivate",)}
    if spec.spec:
        # graftspec: the decode ladder never dispatches — the verify
        # rungs (and the draft-model ladder, when resident) stand in.
        keys |= {("verify", kk) for kk in spec.spec_rungs}
        if spec.spec_draft:
            keys |= {("draft", kk) for kk in spec.spec_rungs}
    else:
        keys |= {("decode", n) for n in spec.decode_rungs}
    if spec.paged and spec.prefix:
        keys.add(("cow",))

    if spec.chunked:
        # Resident-width domain: bucket(start) over the reachable chunk
        # starts, with the minimum start per width bounding which chunk
        # buckets still fit in the prompt behind it.
        min_start = {0: 0}
        for s in _chunk_starts(spec):
            if s == 0:
                continue
            w = _bucket(spec.buckets, spec.max_seq_len, s)
            min_start.setdefault(w, s)
        for sc in spec.chunk_buckets:
            min_rem = _prev(spec.chunk_buckets, sc) + 1
            gmax = min(spec.max_admit, spec.max_slots,
                       spec.token_budget // sc)
            if gmax < 1:
                continue
            for w, ms in min_start.items():
                if ms + min_rem > maxp:
                    continue
                for g in _group_rungs(gmax):
                    keys.add(("chunk", sc, g, w))
        if spec.prefix and not spec.paged:
            # Dense warm starts seed the trie KV into the slot cache,
            # one scatter variant per matched-prefix width.
            for w in spec.buckets:
                mp = _min_prefix(spec, w)
                if mp <= w and mp + 1 <= maxp:
                    keys.add(("seed-prefix", w))
        return keys

    groups = _group_rungs(min(spec.max_admit, spec.max_slots))
    if spec.paged:
        for sb in spec.buckets:
            for g in groups:
                keys.add(("admit-paged", sb, g, 0))
                if not spec.prefix:
                    continue
                for w in spec.buckets:
                    mp = _min_prefix(spec, w)
                    if mp <= w and mp + _prev(spec.buckets, sb) + 1 <= maxp:
                        keys.add(("admit-paged", sb, g, w))
        return keys

    for sb in spec.buckets:
        for g in groups:
            keys.add(("admit", sb, g))
    if spec.prefix:
        for pb in spec.buckets:
            mp = _min_prefix(spec, pb)
            if mp > pb:
                continue
            for sb in spec.buckets:
                if mp + _prev(spec.buckets, sb) + 1 > maxp:
                    continue
                for g in groups:
                    keys.add(("admit-prefix", pb, sb, g))
    return keys


def simulate_keys(spec: LatticeSpec) -> Set[Key]:
    """Operational enumeration: walk every (prompt length, block-aligned
    prefix match) pair through the scheduler arithmetic — bucketing,
    chunk walks, budget packing, pow2 group padding — and collect the
    keys it dispatches.  Deliberately written scenario-style (loops over
    concrete lengths, transliterating the engine's code paths) rather
    than as set algebra, so it fails independently of dispatch_keys();
    the certifier's grid check is the two derivations agreeing."""
    maxp = max(spec.buckets)
    smax = spec.max_seq_len
    if spec.ragged:
        # Scenario walk: every prompt, at every prefix-match offset,
        # prefills in ceil(rem / C) waves and decodes one step per
        # wave — and EVERY one of those dispatches is the same fixed
        # [max_slots, ragged_chunk] kernel. Only warm partial-block
        # tails add the CoW copy.
        keys = {("deactivate",)}
        if spec.prefix:
            keys.add(("cow",))
        for plen in range(1, maxp + 1):
            start = 0
            while start < plen:
                keys.add(("ragged", spec.ragged_chunk))  # prefill wave
                start += spec.ragged_chunk
            keys.add(("ragged", spec.ragged_chunk))      # decode wave
        return keys
    keys: Set[Key] = {("deactivate",)}
    if spec.spec:
        # Scenario walk: every boundary's decode leg is ONE verify wave
        # at the rung the pilot currently flies — and the pilot's
        # envelope is the whole ladder, so every rung is reachable
        # (with its draft-model twin when one is resident).
        for kk in spec.spec_rungs:
            keys.add(("verify", kk))
            if spec.spec_draft:
                keys.add(("draft", kk))
    else:
        keys |= {("decode", n) for n in spec.decode_rungs}
    if spec.paged and spec.prefix:
        keys.add(("cow",))

    def prefix_lens(plen: int) -> List[int]:
        # trie matches are block-aligned and capped at plen - 1
        if not spec.prefix:
            return [0]
        return [0] + list(range(spec.prefix_block, plen,
                                spec.prefix_block))

    def admit_groups() -> List[int]:
        gmax = min(spec.max_admit, spec.max_slots)
        return sorted({pow2ceil(g) for g in range(1, gmax + 1)})

    if spec.chunked:
        c = spec.prefill_chunk
        for plen in range(1, maxp + 1):
            for p0 in prefix_lens(plen):
                if p0 and not spec.paged:
                    keys.add(
                        ("seed-prefix", _bucket(spec.buckets, smax, p0))
                    )
                start = p0
                while start < plen:
                    rem = plen - start
                    final = rem <= c
                    sc = _chunk_bucket(spec.chunk_buckets, rem) \
                        if final else c
                    w = 0 if start == 0 \
                        else _bucket(spec.buckets, smax, start)
                    gmax = min(spec.max_admit, spec.max_slots,
                               spec.token_budget // sc)
                    for g in range(1, gmax + 1):
                        keys.add(("chunk", sc, pow2ceil(g), w))
                    start += rem if final else c
        return keys

    for plen in range(1, maxp + 1):
        for p0 in prefix_lens(plen):
            sb = _bucket(spec.buckets, smax, plen - p0)
            if spec.paged:
                w = _bucket(spec.buckets, smax, p0) if p0 else 0
                for g in admit_groups():
                    keys.add(("admit-paged", sb, g, w))
            elif p0:
                pb = _bucket(spec.buckets, smax, p0)
                for g in admit_groups():
                    keys.add(("admit-prefix", pb, sb, g))
            else:
                for g in admit_groups():
                    keys.add(("admit", sb, g))
    return keys


# Warmup / report ordering: lifecycle freeze first, admission families
# in the middle, decode rungs last (matching the historical warmup
# sequence), numeric components ascending within a family.
_FAMILY_RANK = {
    "deactivate": 0, "admit": 1, "admit-prefix": 2, "admit-paged": 3,
    "seed-prefix": 4, "chunk": 5, "cow": 6, "decode": 7, "ragged": 8,
    "draft": 9, "verify": 10,
}

# The dispatch-family set in warmup order — THE exported constant for
# anything that enumerates families (tests, docs, audits). Derived from
# FAMILIES so a new family cannot be registered without appearing here.
FAMILY_TAGS: Tuple[str, ...] = tuple(
    sorted(FAMILIES, key=_FAMILY_RANK.__getitem__))


def warmup_order(keys: Set[Key]) -> List[Key]:
    return sorted(keys, key=lambda k: (_FAMILY_RANK[k[0]], k[1:]))


# --- certifier grid: single source of truth ---------------------------------
# The component constants below ARE the grid; tests derive counts from
# GRID_COUNT and membership from FAMILY_TAGS instead of pinning
# literals.

# (buckets, smax, slots, max_admit, C, budget)
GRID_SHAPES: Tuple[Tuple, ...] = (
    ((32, 128), 256, 8, 8, 64, 64),
    ((32, 128), 128, 8, 8, 64, 64),    # top bucket fills the window
    ((16, 64), 64, 4, 4, 32, 96),      # budget packs 3 chunks
    ((64,), 128, 2, 2, 64, 64),        # single bucket
)
# (paged, chunked, prefix) — the full flag cube.
GRID_FLAG_COMBOS: Tuple[Tuple[bool, bool, bool], ...] = tuple(
    itertools.product((False, True), repeat=3))
# Ragged leg: paged+chunked forced, prefix trie on/off.
GRID_RAGGED_COMBOS: Tuple[bool, ...] = (False, True)
# Spec leg: (chunked, draft-resident), over the first two shapes only.
GRID_SPEC_COMBOS: Tuple[Tuple[bool, bool], ...] = tuple(
    itertools.product((False, True), repeat=2))
GRID_SPEC_SHAPES = 2

GRID_COUNT = (len(GRID_FLAG_COMBOS) * len(GRID_SHAPES)
              + len(GRID_RAGGED_COMBOS) * len(GRID_SHAPES)
              + len(GRID_SPEC_COMBOS) * GRID_SPEC_SHAPES)


def grid() -> List[LatticeSpec]:
    """Representative spec grid for the certifier: all 8 flag combos
    over several bucket shapes, including the top-bucket == cache-window
    case (the historical warmup-width blind spot) and a multi-chunk
    dispatch budget. Built from the GRID_* constants above — len(grid())
    == GRID_COUNT by construction."""
    shapes = GRID_SHAPES
    specs = []
    for paged, chunked, prefix in GRID_FLAG_COMBOS:
        for buckets, smax, slots, ma, c, budget in shapes:
            specs.append(LatticeSpec(
                buckets=buckets, max_seq_len=smax, max_slots=slots,
                max_admit=ma, decode_rungs=(4, 8), paged=paged,
                chunked=chunked, prefix=prefix, prefix_block=16,
                chunk_buckets=tuple(sorted({min(b, c) for b in buckets}
                                           | {c})) if chunked else (),
                prefill_chunk=c if chunked else 0,
                token_budget=budget if chunked else 0,
            ))
    # graftragged collapse: same shapes, paged+chunked forced (the
    # ragged wave's preconditions), with and without the prefix trie.
    for prefix in GRID_RAGGED_COMBOS:
        for buckets, smax, slots, ma, c, budget in shapes:
            specs.append(LatticeSpec(
                buckets=buckets, max_seq_len=smax, max_slots=slots,
                max_admit=ma, decode_rungs=(4, 8), paged=True,
                chunked=True, prefix=prefix, prefix_block=16,
                chunk_buckets=tuple(sorted({min(b, c) for b in buckets}
                                           | {c})),
                prefill_chunk=c, token_budget=budget,
                ragged=True, ragged_chunk=c,
            ))
    # graftspec: the verify/draft ladders replace the decode rungs —
    # paged forced (spec's precondition), crossed with chunked prefill
    # and draft-model residency.
    for chunked, sdraft in GRID_SPEC_COMBOS:
        for buckets, smax, slots, ma, c, budget in shapes[:GRID_SPEC_SHAPES]:
            specs.append(LatticeSpec(
                buckets=buckets, max_seq_len=smax, max_slots=slots,
                max_admit=ma, decode_rungs=(4, 8), paged=True,
                chunked=chunked, prefix=False, prefix_block=16,
                chunk_buckets=tuple(sorted({min(b, c) for b in buckets}
                                           | {c})) if chunked else (),
                prefill_chunk=c if chunked else 0,
                token_budget=budget if chunked else 0,
                spec=True, spec_rungs=(1, 2, 4), spec_draft=sdraft,
            ))
    return specs


def check_spec(spec: LatticeSpec) -> Tuple[List[Key], List[Key]]:
    """(holes, waste) for one spec: holes are operationally reachable
    keys the closed form misses (live retraces in waiting — warmup
    would skip them); waste is closed-form keys the exhaustive
    enumeration never reaches (warmup would dispatch them for nothing)."""
    closed = dispatch_keys(spec)
    seen = simulate_keys(spec)
    return warmup_order(seen - closed), warmup_order(closed - seen)
