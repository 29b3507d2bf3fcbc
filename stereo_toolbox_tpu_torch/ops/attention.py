"""Softmax attention of the ViT blocks (PyTorch).

Counterpart of the attention core of
``stereo_toolbox_tpu/models/depth_anything_v2.py`` (`_vit_attention_fn`), in
the layout ``[B, heads, N, head_dim]``:

  * `attention` launches a hand-written CUDA kernel
    (``csrc/vit_attention.cu``, K7) on a CUDA tensor, at every N, one design
    per type: bfloat16 runs FlashAttention-2 on the tensor cores ("mma"),
    float32 the online softmax on the CUDA cores ("simt", held to 1e-5 with
    TF32 off). On a CPU tensor it runs `attention_reference`. It counts its
    launches, in all (``.launches``), by ``(B, heads, N, head_dim)``
    (``.shapes``) and by design (``.designs``).
"""

from __future__ import annotations

from collections import Counter

import torch

from stereo_toolbox_tpu_torch.ops import _cuda

HEAD_DIM = 64   # the kernels' head dim; every DepthAnythingV2 encoder has it
QUERY_TILE = KEY_TILE = 64   # both kernels' queries a block and keys a step


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Plain ``softmax(q · kᵀ · scale) · v`` over ``[..., N, d]`` tensors,
    the softmax and the products in float32, the output in the input
    dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(logits, dim=-1), v.float()).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """Non-causal softmax attention ``softmax(q · kᵀ · scale) · v`` over
    ``[B, heads, N, head_dim]`` → ``[B, heads, N, head_dim]``.

    CPU tensors take `attention_reference`; CUDA tensors launch the kernel
    of their type (contiguous bfloat16: tensor cores; float32: CUDA cores;
    all three of one shape, head_dim 64, 16-byte aligned) or raise.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
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
    design = "mma" if q.dtype == torch.bfloat16 else "simt"
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
# ("mma" | "simt", queries of a block, keys a step)
attention.launches = 0
attention.shapes = Counter()
attention.designs = Counter()
