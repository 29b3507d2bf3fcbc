"""K7-bwd's float32 design ("tf32x3") with mma.sync's truncated sums (CPU).

    python3 k7_bwd_truncation.py      # from the repository's root; ~2 min

mma.sync m16n8k8 writes its float32 sums rounded toward zero. This script
models that (each mma's exact sum of its 8 TF32 products and the incoming
accumulator, rounded toward zero to float32) and runs the backward's
arithmetic (S, P = exp2(S·scale·log2e − lse·log2e), dV = Pᵀ·dO, dS = P ∘
(dO·Vᵀ − di), dQ, dK) with three ways of summing the 3xTF32 products:

- ``chain``: one accumulator across every k8 step (the forward's S);
- ``step``: each k8 step's three products into fresh registers, added to
  the accumulator once, rounded to nearest (the backward's S and dP);
- ``tile``: fresh registers for each 64-token tile (the backward's dQ, dK,
  dV, and the forward's P·V).

The log-sum-exp comes from an emulated forward (``chain`` S), as the card's
forward kernel saves it. Each reading is max|got − ref| / max|ref| of dQ,
dK, dV against `attention_backward_reference` (float32, the card's gate of
1e-5) and against the same in float64.
"""

import numpy as np
import torch

from stereo_toolbox_tpu_torch.ops.attention import (
    attention_backward_reference, attention_reference)
from stereo_toolbox_tpu_torch.utils.precision import tf32_split


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 `x` to float32, rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def product(a, b, mode: str) -> torch.Tensor:
    """``a @ b`` (float32) in 3xTF32 on emulated m16n8k8 steps, summed as
    `mode` says."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    fresh = torch.zeros_like(acc)
    width = {"chain": None, "step": 8, "tile": 64}[mode]
    depth = a.shape[-1]
    for k0 in range(0, depth, 8):
        k = slice(k0, k0 + 8)
        into = acc if width is None else fresh
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            into = round_toward_zero(into.double() + x[..., k] @ y[..., k, :])
        if width is None:
            acc = into
        elif (k0 + 8) % width == 0 or k0 + 8 >= depth:
            acc, fresh = acc + into, torch.zeros_like(acc)
        else:
            fresh = into
    return acc


def backward(q, k, v, do, lse, di, scale, scores: str, grads: str):
    s = product(q, k.transpose(-1, -2), scores)
    p = torch.exp2(s * (scale * 1.4426950408889634)
                   - (lse * 1.4426950408889634)[..., None])
    dv = product(p.transpose(-1, -2), do, grads)
    ds = p * (product(do, v.transpose(-1, -2), scores) - di[..., None])
    return (product(ds, k, grads) * scale,
            product(ds.transpose(-1, -2), q, grads) * scale, dv)


def worst(got, want) -> str:
    """max|got − want| / max|want| of each pair, as "dQ/dK/dV"."""
    return "/".join(
        f"{(g.double() - w.double()).abs().max() / w.double().abs().max():.2e}"
        for g, w in zip(got, want))


def main() -> None:
    torch.set_num_threads(8)
    for b, heads, n, scale in ((1, 2, 65, 1.0), (1, 2, 200, 1.0),
                               (1, 2, 641, 0.125)):
        rng = np.random.RandomState(n)
        q, k, v, do = (torch.from_numpy(rng.randn(b, heads, n, 64).astype(
            np.float32)) for _ in range(4))
        lse = torch.logsumexp(product(q, k.transpose(-1, -2), "chain")
                              .double() * scale, -1).float()
        di = (do * attention_reference(q, k, v, scale)).sum(-1)
        ref = attention_backward_reference(q, k, v, None, do, lse, scale,
                                           di=di)
        truth = attention_backward_reference(
            q.double(), k.double(), v.double(), None, do.double(),
            lse.double(), scale, di=di.double())
        print(f"(B, heads, N) {(b, heads, n)}, scale {scale}: dQ/dK/dV, "
              f"float32 plain vs float64 {worst(ref, truth)}", flush=True)
        for scores, grads in (("chain", "tile"), ("step", "tile"),
                              ("chain", "chain")):
            got = backward(q, k, v, do, lse, di, scale, scores, grads)
            print(f"  S, dP {scores:5s}, gradients {grads:5s}: vs float32 "
                  f"{worst(got, ref)}, vs float64 {worst(got, truth)}",
                  flush=True)


if __name__ == "__main__":
    main()
