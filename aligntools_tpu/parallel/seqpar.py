"""Sequence parallelism: one pair's TARGET axis sharded across the mesh.

The reference allocates O(m*n) doubles for fit-mode targets up to 114 KB
(SURVEY.md §5 "long-context"); this module is the scaling story
for that axis: the target (and every DP row) is split into contiguous
column blocks, one per device on the mesh's ``seq`` axis, and the row-scan
engine runs under ``shard_map`` with two tiny collectives per row:

  * the diagonal/vertical predecessors at a block's first column live on
    the LEFT neighbor (its last column of the previous row, plus the
    current row's M for the in-row scans) — one ``ppermute`` shift of a
    few scalars per row;
  * the in-row max-plus scans (U state, fit's J, overlap's LEFT chain,
    edit's min chain) decompose exactly: local Hillis-Steele cummax over
    the block, then an ``all_gather`` of the D per-block maxima and a
    local exclusive prefix — the same normalization trick as
    engine/scan.py, so results are bit-identical to the single-device
    engines.

Per row that is O(D) scalars of interconnect traffic against O(n/D)
vector work — latency-bound but tiny; the win is that each device's
working rows shrink by D, so targets far beyond one device's appetite
stream at full vector width.

Full alignments (round 2): ``seqpar_align`` runs the same sharded fill
with per-device packed-pointer slab emission — each device stacks its
block's pointer rows via the scan's ys output, shard_map assembles them
into the (m_pad/rpb, n_pad) global tensor (P(None, 'seq')-sharded, never
gathered to the host), start info reduces across devices with pmax/pmin
respecting the reference's tie-break order, and the batched device walk
(engine/device_tb.py) emits the rows. Slabs are bit-packed in the scan
itself (rpb query rows per step): 4 rows/byte for overlap's 2-bit codes,
2 rows/byte (nibbles) for the affine modes, full bytes only for
fit+jump's 6 bits — so sharded full-alignment HBM is 2-4x smaller than
one byte per cell. Score-only remains the cheap path. All modes (edit
has no traceback).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from aligntools_tpu.params import AlignParams

NEG = -jnp.inf


def _dist_scan_max(cand, seed, axis):
    """Distributed inclusive max-scan of ``cand`` (local block) with a
    global seed folded in at position 0. Returns the local slice of the
    global running max. Exact: plain maxima, no arithmetic."""
    local = jax.lax.cummax(cand)
    d = jax.lax.axis_index(axis)
    tops = jax.lax.all_gather(local[-1], axis)  # (D,)
    ids = jnp.arange(tops.shape[0])
    prefix = jnp.max(jnp.where(ids < d, tops, NEG))
    prefix = jnp.maximum(prefix, seed)
    return jnp.maximum(local, prefix)


def _shift_from_left(row, incoming, axis):
    """Global shift-right-by-one across blocks: lane 0 receives the left
    neighbor's last element (``incoming`` is this device's own last element
    BEFORE the permute; device 0's lane 0 gets ``incoming``'s replacement
    by the caller via where on axis_index)."""
    d = jax.lax.axis_index(axis)
    n_dev = jax.lax.axis_size(axis)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    from_left = jax.lax.ppermute(incoming, axis, perm)
    return jnp.concatenate([from_left[None], row[:-1]]), d


def _seqpar_local_fn(mode, use_jump, axis):
    """Per-pair local shard body (one device's target block); used by the
    single-pair path and vmapped over the batch shard in the dp x sp
    composition."""

    def local_fn(q_arr, t_arr, allow, n, params):
        match, mis = params[0], params[1]
        o, e, jp = params[2], params[3], params[4]
        m = params[5].astype(jnp.int32)
        W = t_arr.shape[0]
        d = jax.lax.axis_index(axis)
        jglob = d * W + jnp.arange(1, W + 1, dtype=jnp.int32)  # global cols
        jf = jglob.astype(jnp.float32)
        first = d == 0
        in_n = jglob <= n
        eq_n = jglob == n
        lt_n = jglob <= n - 1

        if mode == "global":
            m0 = jnp.full(W, NEG)
            l0 = jnp.full(W, NEG)
            u0row = params[2] + params[3] * jf  # o + e*j
        elif mode in ("local",):
            m0 = jnp.zeros(W)
            l0 = jnp.zeros(W)
            u0row = jnp.zeros(W)
        elif mode == "fit":
            m0 = jnp.zeros(W)
            l0 = jnp.full(W, NEG)
            u0row = jnp.zeros(W)
        elif mode == "overlap":
            m0 = jnp.full(W, NEG)
            l0 = u0row = jnp.zeros(W)  # unused
        else:  # edit
            m0 = jf
            l0 = u0row = jnp.zeros(W)  # unused
        j0row = jnp.full(W, NEG)

        def border_cols(i):
            """(M, L, U, J) at global column 0 of row i (device 0 only)."""
            i_f = i.astype(jnp.float32)
            if mode == "global":
                return (
                    jnp.where(i == 0, 0.0, NEG),
                    o + e * i_f,
                    jnp.where(i == 0, o, NEG),
                    NEG,
                )
            if mode == "local":
                return 0.0, 0.0, 0.0, NEG
            if mode == "fit":
                z = jnp.where(i == 0, 0.0, NEG)
                return z, NEG, z, NEG
            if mode == "overlap":
                return 0.0, NEG, NEG, NEG
            return i_f, NEG, NEG, NEG  # edit: M(i,0) = i

        def step(carry, qc):
            mp, lp, up, jpr, acc = carry
            i = acc["i"] + 1
            sub = jnp.where(t_arr == qc, match, mis)
            if mode == "edit":
                sub = jnp.where(t_arr == qc, 0.0, mis)
            # previous-row boundary from the left neighbor
            bM, bL, bU, bJ = border_cols(i - 1)
            mp_s, _ = _shift_from_left(mp, mp[-1], axis)
            lp_s, _ = _shift_from_left(lp, lp[-1], axis)
            up_s, _ = _shift_from_left(up, up[-1], axis)
            mp_s = mp_s.at[0].set(jnp.where(first, bM, mp_s[0]))
            lp_s = lp_s.at[0].set(jnp.where(first, bL, lp_s[0]))
            up_s = up_s.at[0].set(jnp.where(first, bU, up_s[0]))
            if mode == "edit":
                # min-plus: row[j]=min(prev[j-1]+sub, prev[j]+1, row[j-1]+1)
                cand = jnp.minimum(mp_s + sub, mp + 1.0)
                # seed = row(i,0) - 0 = i, REPLICATED: _dist_scan_max folds
                # the seed into every device's prefix (it precedes all cols)
                v = -_dist_scan_max(-(cand - jf), -i.astype(jnp.float32), axis)
                row = v + jf
                fin = jnp.max(jnp.where(eq_n, row, NEG))
                fin = jax.lax.pmax(fin, axis)
                acc = {
                    "i": i,
                    "best": jnp.where(i == m, fin, acc["best"]),
                    "aux": acc["aux"],
                }
                return (row, lp, up, jpr, acc), None
            if mode == "overlap":
                dr = jnp.maximum(mp_s + sub, mp + o)
                # seed = M(i,0) - o*0 = 0, replicated (see edit-mode note)
                v = _dist_scan_max(dr - o * jf, jnp.float32(0.0), axis)
                row = v + o * jf
                rowmax = jnp.max(jnp.where(lt_n, row, NEG))
                rowmax = jnp.maximum(jax.lax.pmax(rowmax, axis), 0.0)
                acc = {
                    "i": i,
                    "best": jnp.where(i == m, rowmax, acc["best"]),
                    "aux": acc["aux"],
                }
                return (row, lp, up, jpr, acc), None
            # affine family
            diag = jnp.maximum(jnp.maximum(lp_s, mp_s), up_s)
            if use_jump:
                jp_s, _ = _shift_from_left(jpr, jpr[-1], axis)
                jp_s = jp_s.at[0].set(jnp.where(first, bJ, jp_s[0]))
                diag = jnp.maximum(diag, jp_s)
            m_row = diag + sub
            if mode == "local":
                m_row = jnp.maximum(m_row, 0.0)
            l_row = jnp.maximum(lp + e, mp + o)
            # current-row M boundary for the in-row scans
            m_cur_s, _ = _shift_from_left(m_row, m_row[-1], axis)
            bMi, _, _, _ = border_cols(i)
            m_cur_s = m_cur_s.at[0].set(jnp.where(first, bMi, m_cur_s[0]))
            u_seed = {
                "global": NEG, "local": 0.0, "fit": NEG,
            }[mode]
            cand = m_cur_s + o - e * jf
            v = _dist_scan_max(cand, jnp.float32(u_seed), axis)
            u_row = v + e * jf
            if use_jump:
                jcand = jnp.where(allow > 0.0, m_cur_s + jp, NEG)
                j_row = _dist_scan_max(jcand, jnp.float32(NEG), axis)
            else:
                j_row = jpr
            # per-mode score tracking
            if mode == "global":
                fin = jnp.max(
                    jnp.where(
                        eq_n, jnp.maximum(jnp.maximum(l_row, m_row), u_row),
                        NEG,
                    )
                )
                fin = jax.lax.pmax(fin, axis)
                best = jnp.where(i == m, fin, acc["best"])
            elif mode == "local":
                rowmax = jnp.max(jnp.where(in_n, m_row, NEG))
                rowmax = jax.lax.pmax(rowmax, axis)
                rowmax = jnp.where(i <= m, rowmax, NEG)
                best = jnp.maximum(acc["best"], rowmax)
            else:  # fit
                rowmax = jnp.max(
                    jnp.where(lt_n, jnp.maximum(m_row, l_row), NEG)
                )
                rowmax = jax.lax.pmax(rowmax, axis)
                best = jnp.where(i == m, rowmax, acc["best"])
            acc = {"i": i, "best": best, "aux": acc["aux"]}
            return (m_row, l_row, u_row, j_row, acc), None

        acc0 = {"i": jnp.int32(0), "best": NEG, "aux": jnp.float32(0)}
        (_, _, _, _, acc), _ = jax.lax.scan(
            step, (m0, l0, u0row, j0row, acc0), q_arr.astype(jnp.float32)
        )
        return acc["best"]


    return local_fn


def _seqpar_local_ptr_fn(mode, use_jump, axis, rpb=1):
    """Like _seqpar_local_fn but emits packed pointer rows (columns
    1..n_pad) as the scan's ys and tracks full traceback-start info.

    ``rpb`` (DP rows per byte) selects the slab layout — the same three
    engine/device_tb.py decodes used by the flat/blocked kernels:
      1: engine/scan.py byte layout (required for fit+jump's 6 bits);
      2: nibble layout — pM 2 bits (3 = HOME/unset), L bit 2, U bit 3;
         the scan steps TWO query rows per iteration so only the packed
         byte is ever materialized (half the slab HBM of rpb=1);
      4: overlap's 2-bit codes, FOUR rows per scan step.
    Returns (score, a, b, ptrs) where ptrs is this device's
    (m_pad/rpb, W) slab and a/b are the per-mode start scalars (global:
    state; local: i_max/j_max; fit: use_l/j_max; overlap: j_max/-)."""
    BIGF = jnp.float32(1 << 30)

    def local_fn(q_arr, t_arr, allow, n, params):
        match, mis = params[0], params[1]
        o, e, jp = params[2], params[3], params[4]
        m = params[5].astype(jnp.int32)
        W = t_arr.shape[0]
        d = jax.lax.axis_index(axis)
        jglob = d * W + jnp.arange(1, W + 1, dtype=jnp.int32)
        jf = jglob.astype(jnp.float32)
        first = d == 0
        in_n = jglob <= n
        eq_n = jglob == n
        lt_n = jglob <= n - 1

        if mode == "global":
            m0 = jnp.full(W, NEG)
            l0 = jnp.full(W, NEG)
            u0row = o + e * jf
            u_seed = NEG
        elif mode == "local":
            m0 = jnp.zeros(W)
            l0 = jnp.zeros(W)
            u0row = jnp.zeros(W)
            u_seed = 0.0
        elif mode == "fit":
            m0 = jnp.zeros(W)
            l0 = jnp.full(W, NEG)
            u0row = jnp.zeros(W)
            u_seed = NEG
        else:  # overlap
            m0 = jnp.full(W, NEG)
            l0 = u0row = jnp.zeros(W)
            u_seed = NEG
        j0row = jnp.full(W, NEG)

        def border_cols(i):
            i_f = i.astype(jnp.float32)
            if mode == "global":
                return (
                    jnp.where(i == 0, 0.0, NEG),
                    o + e * i_f,
                    jnp.where(i == 0, o, NEG),
                    NEG,
                )
            if mode == "local":
                return 0.0, 0.0, 0.0, NEG
            if mode == "fit":
                z = jnp.where(i == 0, 0.0, NEG)
                return z, NEG, z, NEG
            return 0.0, NEG, NEG, NEG  # overlap: M(i,0)=0

        def pmin(x):
            return -jax.lax.pmax(-x, axis)

        def first_eq(vec, target, mask):
            hit = (vec == target) & mask
            return pmin(jnp.min(jnp.where(hit, jf, BIGF)))

        def step(carry, qc):
            mp, lp, up, jpr, acc = carry
            i = acc["i"] + 1
            sub = jnp.where(t_arr == qc, match, mis)
            bM, bL, bU, bJ = border_cols(i - 1)
            mp_s, _ = _shift_from_left(mp, mp[-1], axis)
            mp_s = mp_s.at[0].set(jnp.where(first, bM, mp_s[0]))
            bMi, _, _, _ = border_cols(i)
            if mode == "overlap":
                # arg order LEFT, DIAG, RIGHT (alignment.h:944); the LEFT
                # chain is the distributed slope-o scan
                diag = mp_s + sub
                right = mp + o
                dr = jnp.maximum(diag, right)
                v = _dist_scan_max(dr - o * jf, jnp.float32(0.0), axis)
                row = v + o * jf
                row_s, _ = _shift_from_left(row, row[-1], axis)
                row_s = row_s.at[0].set(jnp.where(first, bMi, row_s[0]))
                left = row_s + o
                code = jnp.where(
                    left >= row, 0, jnp.where(diag >= right, 1, 2)
                )
                packed = jnp.where(row > NEG, code, 3).astype(jnp.uint8)
                rowmax = jax.lax.pmax(
                    jnp.max(jnp.where(lt_n, row, NEG)), axis
                )
                jarg = first_eq(row, rowmax, lt_n)
                score = jnp.maximum(rowmax, 0.0)
                jarg = jnp.where(rowmax > 0.0, jarg, 0.0)
                latch = i == m
                acc = {
                    "i": i,
                    "best": jnp.where(latch, score, acc["best"]),
                    "a": jnp.where(latch, jarg, acc["a"]),
                    "b": acc["b"],
                }
                return (row, lp, up, jpr, acc), packed
            lp_s, _ = _shift_from_left(lp, lp[-1], axis)
            up_s, _ = _shift_from_left(up, up[-1], axis)
            lp_s = lp_s.at[0].set(jnp.where(first, bL, lp_s[0]))
            up_s = up_s.at[0].set(jnp.where(first, bU, up_s[0]))
            # M argmax in reference arg order L, M, U [, J] [, HOME]
            # (alignment.h:451/825/635): earliest argument wins ties
            cands = [lp_s + sub, mp_s + sub, up_s + sub]
            if use_jump:
                jp_s, _ = _shift_from_left(jpr, jpr[-1], axis)
                jp_s = jp_s.at[0].set(jnp.where(first, bJ, jp_s[0]))
                cands.append(jp_s + sub)
            if mode == "local":
                cands.append(jnp.zeros(W))  # 0.0 HOME is the LAST arg
            vals = jnp.stack(cands)
            m_row = vals.max(axis=0)
            pm = jnp.argmax(vals, axis=0).astype(jnp.int32)
            if rpb == 1:
                if mode == "local" and not use_jump:
                    pm = jnp.where(pm == 3, 4, pm)  # HOME code is 4, not 3
                pm = jnp.where(m_row > NEG, pm, 7)
            else:  # nibble layout: pM 2 bits, code 3 = HOME/unset
                pm = jnp.where(m_row > NEG, jnp.minimum(pm, 3), 3)
            lbit = 1 << 3 if rpb == 1 else 1 << 2
            ubit = 1 << 4 if rpb == 1 else 1 << 3
            la, lb2 = lp + e, mp + o
            l_row = jnp.maximum(la, lb2)
            plbit = jnp.where(la >= lb2, 0, lbit)
            m_cur_s, _ = _shift_from_left(m_row, m_row[-1], axis)
            m_cur_s = m_cur_s.at[0].set(jnp.where(first, bMi, m_cur_s[0]))
            cand = m_cur_s + o - e * jf
            v = _dist_scan_max(cand, jnp.float32(u_seed), axis)
            u_row = v + e * jf
            u_s, _ = _shift_from_left(u_row, u_row[-1], axis)
            u_s = u_s.at[0].set(jnp.where(first, jnp.float32(u_seed), u_s[0]))
            pubit = jnp.where(m_cur_s + o >= u_s + e, 0, ubit)
            if use_jump:
                jc = jnp.where(allow > 0.0, m_cur_s + jp, NEG)
                j_row = _dist_scan_max(jc, jnp.float32(NEG), axis)
                j_s, _ = _shift_from_left(j_row, j_row[-1], axis)
                j_s = j_s.at[0].set(jnp.where(first, NEG, j_s[0]))
                pjbit = jnp.where((jc > NEG) & (jc >= j_s), 0, 1 << 5)
            else:
                j_row = jpr
                pjbit = 0
            packed = (pm | plbit | pubit | pjbit).astype(jnp.uint8)
            # start info
            if mode == "global":
                ln = jax.lax.pmax(jnp.max(jnp.where(eq_n, l_row, NEG)), axis)
                mn = jax.lax.pmax(jnp.max(jnp.where(eq_n, m_row, NEG)), axis)
                un = jax.lax.pmax(jnp.max(jnp.where(eq_n, u_row, NEG)), axis)
                fin = jnp.maximum(jnp.maximum(ln, mn), un)
                st = jnp.where(
                    (ln >= mn) & (ln >= un), 0.0, jnp.where(mn >= un, 1.0, 2.0)
                )
                latch = i == m
                acc = {
                    "i": i,
                    "best": jnp.where(latch, fin, acc["best"]),
                    "a": jnp.where(latch, st, acc["a"]),
                    "b": acc["b"],
                }
            elif mode == "local":
                rowmax = jax.lax.pmax(jnp.max(jnp.where(in_n, m_row, NEG)),
                                      axis)
                jarg = first_eq(m_row, rowmax, in_n)
                upd = (rowmax > acc["best"]) & (i <= m)
                acc = {
                    "i": i,
                    "best": jnp.where(upd, rowmax, acc["best"]),
                    "a": jnp.where(upd, i.astype(jnp.float32), acc["a"]),
                    "b": jnp.where(upd, jarg, acc["b"]),
                }
            else:  # fit: M beats L on ties, smallest j within each
                mb = jax.lax.pmax(jnp.max(jnp.where(lt_n, m_row, NEG)), axis)
                lb3 = jax.lax.pmax(jnp.max(jnp.where(lt_n, l_row, NEG)), axis)
                use_l = lb3 > mb
                fin = jnp.maximum(mb, lb3)
                jarg = jnp.where(
                    use_l,
                    first_eq(l_row, lb3, lt_n),
                    first_eq(m_row, mb, lt_n),
                )
                latch = i == m
                acc = {
                    "i": i,
                    "best": jnp.where(latch, fin, acc["best"]),
                    "a": jnp.where(latch, use_l.astype(jnp.float32),
                                   acc["a"]),
                    "b": jnp.where(latch, jarg, acc["b"]),
                }
            return (m_row, l_row, u_row, j_row, acc), packed

        acc0 = {
            "i": jnp.int32(0), "best": NEG,
            "a": jnp.float32(0), "b": jnp.float32(0),
        }
        carry0 = (m0, l0, u0row, j0row, acc0)
        if rpb == 1:
            (_, _, _, _, acc), ptrs = jax.lax.scan(
                step, carry0, q_arr.astype(jnp.float32)
            )
        else:
            # rpb query rows per scan step: only the packed byte is ever
            # materialized, so the slab is rpb x smaller end to end
            bits = 8 // rpb

            def gstep(carry, qv):
                out = jnp.zeros(t_arr.shape, jnp.int32)
                for r in range(rpb):
                    carry, code = step(carry, qv[r])
                    out = out | (code.astype(jnp.int32) << (r * bits))
                return carry, out.astype(jnp.uint8)

            (_, _, _, _, acc), ptrs = jax.lax.scan(
                gstep, carry0, q_arr.astype(jnp.float32).reshape(-1, rpb)
            )
        return acc["best"], acc["a"], acc["b"], ptrs

    return local_fn


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _seqpar_fill_ptr(mode, n_pad, use_jump, rpb, mesh, q_arr, t_arr, allow,
                     n, params):
    """Sharded full fill: (score, a, b) replicated + the (m_pad/rpb,
    n_pad) packed pointer tensor sharded P(None, 'seq') — assembled from
    the per-device slabs, never leaving the devices."""
    axis = "seq"
    local_fn = _seqpar_local_ptr_fn(mode, use_jump, axis, rpb)
    return jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(), P()),
        out_specs=(P(), P(), P(), P(None, axis)),
        check_vma=False,
    )(q_arr, t_arr, allow, n, params)


def seqpar_align(
    mode: str,
    q: bytes,
    t: bytes,
    params: AlignParams = AlignParams(),
    sites=None,
    mesh: Mesh | None = None,
):
    """Full alignment of one pair with the target sharded across the mesh:
    sharded fill + pointer-slab emission + batched device walk. Rows are
    byte-identical to the single-device engines (and the reference binary
    they are parity-tested against). Returns spec.engine.AlignResult."""
    from aligntools_tpu.engine import device_tb
    from aligntools_tpu.spec.engine import AlignResult

    if mode == "edit":
        raise ValueError("edit mode has no traceback (alignment.h:291-315)")
    if mode == "fit" and len(q) > len(t):
        raise ValueError("first sequence must be shorter than the second")
    if mesh is None:
        devs = jax.devices()
        mesh = Mesh(np.asarray(devs), ("seq",))
    D = mesh.devices.size
    m, n = len(q), len(t)
    quantum = 128 * D
    n_pad = max(quantum, -(-n // quantum) * quantum)
    use_jump = sites is not None and mode == "fit"
    # slab packing: 2-bit codes (4 rows/byte) for overlap, nibbles for
    # the affine modes; fit+jump needs 6 bits so stays at 1 row/byte
    rpb = 1 if use_jump else (4 if mode == "overlap" else 2)
    m_pad = max(8, -(-m // rpb) * rpb)
    qa = np.full(m_pad, -1, np.int32)
    qa[:m] = np.frombuffer(q, np.uint8)
    ta = np.full(n_pad, -2, np.int32)
    ta[:n] = np.frombuffer(t, np.uint8)
    allow = np.ones(n_pad, np.float32)
    if use_jump:
        for s in sites:
            if 0 <= s < n_pad:
                allow[s] = 0.0
    pv = np.array(
        [params.match, params.mismatch, params.gap_open, params.gap_extend,
         params.jump, m, 0, 0],
        np.float32,
    )
    shard = NamedSharding(mesh, P("seq"))
    rep = NamedSharding(mesh, P())
    args = (
        jax.device_put(jnp.asarray(qa), rep),
        jax.device_put(jnp.asarray(ta), shard),
        jax.device_put(jnp.asarray(allow), shard),
        jax.device_put(jnp.int32(n), rep),
        jax.device_put(jnp.asarray(pv), rep),
    )
    score, a, b, ptrs = _seqpar_fill_ptr(mode, n_pad, use_jump, rpb, mesh,
                                         *args)
    score, a, b = float(score), int(a), int(b)
    if mode == "fit" and not np.isfinite(score):
        raise RuntimeError("fit: no finite traceback start (reference UB)")
    if mode == "global":
        start = (a, m, n)
    elif mode == "local":
        start = (1, a, b)
    elif mode == "fit":
        # a = use_l (1 when L wins) -> walk states _LOW=0 / _MID=1
        start = (0 if a else 1, m, b)
    else:  # overlap
        start = (0, m, a)
    rows = device_tb.batch_traceback(
        mode, ptrs[None], qa[None], ta[None], [(q, t)], [start],
        col_base=1, pack4=rpb if rpb > 1 else False,
    )
    return AlignResult(score, *rows[0])


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _seqpar_fill(mode, n_pad, use_jump, mesh, q_arr, t_arr, allow, n, params):
    """Score one pair with the target sharded over mesh('seq').

    q_arr (m_pad,) replicated; t_arr (n_pad,) sharded; allow (n_pad,) f32
    sharded (fit); n scalar; params (8,) f32 [match,mis,o,e,jp,m,0,0].
    """
    axis = "seq"
    local_fn = _seqpar_local_fn(mode, use_jump, axis)
    return jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(q_arr, t_arr, allow, n, params)


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _seqpar_fill_batch(mode, n_pad, use_jump, mesh, qs, ts, allows, ns, ps):
    """dp x sp composition: batch axis sharded over mesh('data'), every
    pair's target sharded over mesh('seq'). The per-pair row-scan body
    (with its per-row ppermute/all_gather collectives over 'seq') is
    vmapped over the local batch shard — collectives over 'seq' commute
    with vmap over the batch dimension.

    qs (B, m_pad) P('data', None); ts (B, n_pad) P('data', 'seq');
    allows like ts (f32); ns (B,) P('data'); ps (B, 8) P('data', None).
    Returns scores (B,) P('data')-sharded.
    """
    axis = "seq"

    def local_fn(qs, ts, allows, ns, ps):
        single = _seqpar_local_fn(mode, use_jump, axis)
        return jax.vmap(single)(qs, ts, allows, ns, ps)

    return jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(
            P("data", None), P("data", axis), P("data", axis), P("data"),
            P("data", None),
        ),
        out_specs=P("data"),
        check_vma=False,
    )(qs, ts, allows, ns, ps)


def seqpar_batch_scores(
    mode: str,
    pairs,
    params: AlignParams = AlignParams(),
    sites_list=None,
    mesh: Mesh | None = None,
):
    """Batch scoring with BOTH parallel axes: dp over mesh('data'), sp over
    mesh('seq'). Bit-identical to the single-device engines."""
    if mesh is None:
        devs = np.asarray(jax.devices())
        mesh = Mesh(devs.reshape(2, -1), ("data", "seq"))
    d_data = mesh.shape["data"]
    d_seq = mesh.shape["seq"]
    B = len(pairs)
    Bp = -(-B // d_data) * d_data
    m_pad = max(8, max(len(q) for q, _ in pairs))
    quantum = 128 * d_seq
    n_max = max(len(t) for _, t in pairs)
    n_pad = max(quantum, -(-n_max // quantum) * quantum)
    use_jump = sites_list is not None and mode == "fit"
    qs = np.full((Bp, m_pad), -1, np.int32)
    ts = np.full((Bp, n_pad), -2, np.int32)
    allows = np.ones((Bp, n_pad), np.float32)
    ns = np.ones(Bp, np.int32)
    ps = np.zeros((Bp, 8), np.float32)
    ps[:, :5] = [params.match, params.mismatch, params.gap_open,
                 params.gap_extend, params.jump]
    for k, (q, t) in enumerate(pairs):
        qs[k, : len(q)] = np.frombuffer(q, np.uint8)
        ts[k, : len(t)] = np.frombuffer(t, np.uint8)
        ns[k] = len(t)
        ps[k, 5] = len(q)
        if use_jump and sites_list[k]:
            for sx in sites_list[k]:
                if 0 <= sx < n_pad:
                    allows[k, sx] = 0.0
    args = (
        jax.device_put(jnp.asarray(qs), NamedSharding(mesh, P("data", None))),
        jax.device_put(jnp.asarray(ts), NamedSharding(mesh, P("data", "seq"))),
        jax.device_put(jnp.asarray(allows),
                       NamedSharding(mesh, P("data", "seq"))),
        jax.device_put(jnp.asarray(ns), NamedSharding(mesh, P("data"))),
        jax.device_put(jnp.asarray(ps), NamedSharding(mesh, P("data", None))),
    )
    out = np.asarray(_seqpar_fill_batch(mode, n_pad, use_jump, mesh, *args))
    out = out[:B]
    if mode == "edit":
        return out.astype(np.int64)
    return out.astype(np.float64)


def seqpar_score(
    mode: str,
    q: bytes,
    t: bytes,
    params: AlignParams = AlignParams(),
    sites=None,
    mesh: Mesh | None = None,
):
    """Score one pair with the target sharded across the mesh's devices.

    Exactness matches the single-device engines bit-for-bit. For 'edit'
    the result is the int distance; others return the float score."""
    if mesh is None:
        devs = jax.devices()
        mesh = Mesh(np.asarray(devs), ("seq",))
    D = mesh.devices.size
    m, n = len(q), len(t)
    quantum = 128 * D
    n_pad = max(quantum, -(-n // quantum) * quantum)
    m_pad = max(8, m)
    use_jump = sites is not None and mode == "fit"
    qa = np.full(m_pad, -1, np.int32)
    qa[:m] = np.frombuffer(q, np.uint8)
    ta = np.full(n_pad, -2, np.int32)
    ta[:n] = np.frombuffer(t, np.uint8)
    allow = np.ones(n_pad, np.float32)
    if use_jump:
        for s in sites:
            if 0 <= s < n_pad:
                allow[s] = 0.0
    pv = np.array(
        [params.match, params.mismatch, params.gap_open, params.gap_extend,
         params.jump, m, 0, 0],
        np.float32,
    )
    shard = NamedSharding(mesh, P("seq"))
    rep = NamedSharding(mesh, P())
    args = (
        jax.device_put(jnp.asarray(qa), rep),
        jax.device_put(jnp.asarray(ta), shard),
        jax.device_put(jnp.asarray(allow), shard),
        jax.device_put(jnp.int32(n), rep),
        jax.device_put(jnp.asarray(pv), rep),
    )
    out = float(_seqpar_fill(mode, n_pad, use_jump, mesh, *args))
    if mode == "edit":
        return int(out)
    return out
