"""A step-by-step emulation of the one-bucket CUDA kernel's schedule
(``src/repro_torch/csrc/gather_reduce.cu``), in numpy on the CPU.

The kernel gives each warp of a row block's ``threads / 32`` one contiguous
range of slots, walks it ``32 * slots`` slots a step (``slots`` consecutive
slots a lane), folds each lane's runs of one row in order, joins the lanes'
last runs by a segmented inclusive shuffle scan (Hillis-Steele, offsets 1,
2, 4, 8, 16), carries the warp's open run into its next step, writes each
finished run once (the range's first run into a staged piece), and at the
end joins the staged pieces in warp order. ``emulate_bucket`` repeats that
arithmetic, so a sum comes out with the kernel's association: the card
tests hold the kernel's bits to it, the CPU tests hold it to the plain
version. Min comes out exact in any order; it checks the run bookkeeping.

No JAX and no ``repro`` here: the card tests import this module too.
"""
import numpy as np

KERNEL_THREADS = 512  # kThreads in gather_reduce.cu
KERNEL_SLOTS = 4  # kSlots in gather_reduce.cu


def _key(bits):
    """float32 bits -> order-preserving uint32 key (as gather_reduce.cu)."""
    return (~bits) & 0xFFFFFFFF if bits & 0x80000000 else bits | 0x80000000


def _unkey(key):
    return key & 0x7FFFFFFF if key & 0x80000000 else (~key) & 0xFFFFFFFF


def emulate_bucket(payload, src, dstb, valid, weights=None, *, vb, kind, edge_op="none",
                   identity=0.0, threads=KERNEL_THREADS, slots=KERNEL_SLOTS):
    """The kernel's output for one bucket: numpy (G,) payload (uint32 or
    float32) and (R, T, Eb) src / dstb / valid (/ weights) -> (R * vb,)."""
    r_blocks = src.shape[0]
    n = int(np.prod(src.shape[1:]))
    src, dstb, valid = (np.asarray(a).reshape(r_blocks, n) for a in (src, dstb, valid))
    if weights is not None:
        weights = np.asarray(weights, np.float32).reshape(r_blocks, n)
    is_f32 = payload.dtype == np.float32
    is_sum = kind == "sum"
    f32 = np.float32
    ident_bits = int(np.float32(identity).view(np.uint32)) if is_f32 else int(identity)
    ident_f = f32(identity)
    init = _key(ident_bits) if (is_f32 and not is_sum) else ident_bits
    start = f32(0.0) if is_sum else init
    if is_sum:
        fold = lambda a, b: f32(a + b)  # noqa: E731
    else:
        fold = min

    def mapped(j_src, w):
        if not is_f32:
            return int(payload[j_src])
        x = f32(payload[j_src])
        if edge_op == "add":
            x = ident_f if x >= ident_f else f32(x + w)
        return x if is_sum else _key(int(np.float32(x).view(np.uint32)))

    warps, step = threads // 32, 32 * slots
    length = -(-(-(-n // warps)) // step) * step
    out = []
    for r in range(r_blocks):
        acc = [f32(identity)] * vb if is_sum else [init] * vb
        st_row, st_val = [-1] * (2 * warps), [f32(0.0)] * (2 * warps)
        for w in range(warps):
            s_end = min(n, (w + 1) * length)
            carry_row, carry, first_row = -1, start, -1

            def finish(rr, v):
                if is_sum:
                    if rr == first_row:
                        st_val[2 * w] = f32(st_val[2 * w] + v)
                    else:
                        acc[rr] = f32(acc[rr] + v)
                elif v != init:
                    acc[rr] = min(acc[rr], v)

            s0 = w * length
            while s0 < s_end:
                h_row, h_val, t_row, t_val, n_runs = [], [], [], [], []
                for lane in range(32):  # each lane folds its runs
                    hr, tr, nr, hv, tv = -1, -1, 0, start, start
                    for i in range(slots):
                        j = s0 + slots * lane + i
                        if j >= s_end or not valid[r, j]:
                            continue
                        row = int(dstb[r, j])
                        v = mapped(int(src[r, j]), f32(weights[r, j]) if weights is not None
                                   else f32(1.0))
                        if row == tr:
                            tv = fold(tv, v)
                            continue
                        if nr == 1:
                            hr, hv = tr, tv
                        elif nr > 1:
                            finish(tr, tv)
                        tr, tv, nr = row, v, nr + 1
                    h_row.append(hr), h_val.append(hv), t_row.append(tr), t_val.append(tv)
                    n_runs.append(nr)
                has = [k > 0 for k in n_runs]
                single = [k == 1 for k in n_runs]
                h = [t_row[k] if single[k] else h_row[k] for k in range(32)]
                if is_sum and first_row < 0 and any(has):
                    first_row = h[has.index(True)]
                joins = [has[k] and h[k] == (carry_row if k == 0 else t_row[k - 1])
                         for k in range(32)]
                v = list(t_val)
                head = [not (single[k] and joins[k]) for k in range(32)]
                if single[0] and joins[0]:
                    v[0] = fold(carry, v[0])
                head[0] = True
                for dd in (1, 2, 4, 8, 16):  # the shuffles read the values before the round
                    v_up, head_up = list(v), list(head)
                    for k in range(dd, 32):
                        if not head[k]:
                            v[k] = fold(v_up[k - dd], v[k])
                            head[k] = head_up[k - dd]
                if carry_row >= 0 and not joins[0]:
                    finish(carry_row, carry)
                for k in range(32):
                    if has[k] and not single[k]:
                        left = carry if k == 0 else v[k - 1]
                        finish(h_row[k], fold(left, h_val[k]) if joins[k] else h_val[k])
                for k in range(31):
                    if has[k] and not joins[k + 1]:
                        finish(t_row[k], v[k])
                carry_row, carry = t_row[31], v[31]
                s0 += step
            if carry_row >= 0:
                if not is_sum:
                    finish(carry_row, carry)
                elif carry_row == first_row:
                    st_val[2 * w] = f32(st_val[2 * w] + carry)
                else:
                    st_row[2 * w + 1], st_val[2 * w + 1] = carry_row, carry
            if is_sum:
                st_row[2 * w] = first_row
        if is_sum:  # the staged pieces, in warp order
            rr, tot = -1, f32(0.0)
            for q in range(2 * warps):
                if st_row[q] < 0:
                    continue
                if st_row[q] == rr:
                    tot = f32(tot + st_val[q])
                    continue
                if rr >= 0:
                    acc[rr] = f32(acc[rr] + tot)
                rr, tot = st_row[q], st_val[q]
            if rr >= 0:
                acc[rr] = f32(acc[rr] + tot)
            out.append(np.asarray(acc, np.float32))
        elif is_f32:
            out.append(np.asarray([_unkey(k) for k in acc], np.uint32).view(np.float32))
        else:
            out.append(np.asarray(acc, np.uint32))
    if not out:
        return np.zeros(0, np.float32 if is_f32 else np.uint32)
    return np.concatenate(out)
