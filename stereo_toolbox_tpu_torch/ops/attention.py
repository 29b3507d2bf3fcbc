"""Softmax attention of the ViT blocks (PyTorch).

Counterpart of the attention core of
``stereo_toolbox_tpu/models/depth_anything_v2.py`` (`_vit_attention_fn`), in
the layout ``[B, heads, N, head_dim]``:

  * `attention` launches a hand-written CUDA kernel
    (``csrc/vit_attention.cu``, K7) on a CUDA tensor, at every N:
    FlashAttention-2 on the tensor cores in both types, one design per
    type. bfloat16 runs ``mma.sync`` m16n8k16 ("mma"); float32 runs 3xTF32
    on ``mma.sync`` m16n8k8 ("tf32x3": each operand split into a TF32 high
    part and a TF32 remainder, three products summed in float32, held to
    1e-5 of the plain version with TF32 off, which one TF32 product would
    miss). Bound on the card by operations (4·N²·64 FLOP a head; float32
    three TF32 products each at 495 TF/s), then by the fragment loads from
    shared memory. On a CPU tensor it runs `attention_reference`. It counts
    its launches, in all (``.launches``), by ``(B, heads, N, head_dim)``
    (``.shapes``) and by design (``.designs``).
  * `attention_tf32x3_reference` computes the float32 kernel's arithmetic
    (the CPU tests use it; nothing on the main path does).
"""

from __future__ import annotations

from collections import Counter

import torch

from stereo_toolbox_tpu_torch.ops import _cuda
from stereo_toolbox_tpu_torch.utils.precision import tf32_split

HEAD_DIM = 64   # the kernels' head dim; every DepthAnythingV2 encoder has it
QUERY_TILE = KEY_TILE = 64   # both kernels' queries a block and keys a step
# The design of each type ("mma": bf16 products; "tf32x3": three TF32
# products of split float32 operands)
DESIGNS = {torch.bfloat16: "mma", torch.float32: "tf32x3"}


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Plain ``softmax(q · kᵀ · scale) · v`` over ``[..., N, d]`` tensors,
    the softmax and the products in float32, the output in the input
    dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(logits, dim=-1), v.float()).to(q.dtype)


def attention_tf32x3_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, scale: float,
                               terms: int = 3) -> torch.Tensor:
    """Plain version in the float32 kernel's arithmetic: q, k, v, and the
    softmax's unnormalised P, split into TF32 high parts and remainders
    (`tf32_split`); S = Q·Kᵀ and P·V each as lo·hi + hi·lo + hi·hi in
    float32; the softmax in log2 units in float32 and the row sum of the
    unsplit P. ``terms=1`` keeps hi·hi alone (one TF32 product), which the
    tests use to show that the float32 gate tells the two apart."""
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")

    def product(a, b):
        (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
        hh = ah @ bh
        return (al @ bh + ah @ bl) + hh if terms == 3 else hh

    logits = product(q.float(), k.float().transpose(-1, -2)) * (
        scale * 1.4426950408889634)
    p = torch.exp2(logits - logits.amax(dim=-1, keepdim=True))
    out = product(p, v.float()) / p.sum(dim=-1, keepdim=True)
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """Non-causal softmax attention ``softmax(q · kᵀ · scale) · v`` over
    ``[B, heads, N, head_dim]`` → ``[B, heads, N, head_dim]``.

    CPU tensors take `attention_reference`; CUDA tensors launch the
    kernel's design for their type (bfloat16: "mma"; float32: "tf32x3";
    all three contiguous, of one shape, head_dim 64, 16-byte aligned) or
    raise.
    """
    if _cuda.on_cpu(q):
        return attention_reference(q, k, v, scale)
    _cuda.refuse_grad("attention (K7)", "DepthAnythingV2 has no train path "
                      "in the port yet (ROADMAP Queue 1); autograd "
                      "differentiates attention_reference", q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v {[tuple(t.shape) for t in (q, k, v)]} must "
                         f"be equal [B, heads, N, head_dim]")
    b, heads, n, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the attention kernel takes head_dim {HEAD_DIM}, "
                         f"got {d}")
    if any(t.device != q.device or t.dtype != q.dtype for t in (k, v)):
        raise ValueError("q, k, v must share device and dtype")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("q, k, v must be contiguous and 16-byte aligned")
    _cuda.dtype_code(q)          # raises on a type no kernel takes
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _cuda.library("vit_attention")
    design = DESIGNS[q.dtype]
    with torch.cuda.device(q.device):
        rc = getattr(lib, f"vit_attention_{design}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * heads, n, float(scale), _cuda.stream_of(q))
    _cuda.check(lib, rc, "vit_attention")
    attention.launches += 1
    attention.shapes[(b, heads, n, d)] += 1
    attention.designs[(design, QUERY_TILE, KEY_TILE)] += 1
    return out


# launches of the kernels, in all, by (B, heads, N, head_dim) and by design
# ("mma" | "tf32x3", queries of a block, keys a step)
attention.launches = 0
attention.shapes = Counter()
attention.designs = Counter()
