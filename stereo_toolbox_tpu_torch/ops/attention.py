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

`attention` is an ``autograd.Function`` wherever an input requires grad. On
the card its forward launches the type's design with a pointer for each
row's log-sum-exp (float32 ``[B · heads, N]``, natural log), which it saves
with q, k, v and the output; its backward forms ``di = rowsum(dO ∘ O)`` in
float32 (one PyTorch reduction, as the JAX library does in XLA outside its
kernels) and launches K7-bwd (`attention_backward`): two hand-written CUDA
kernels, the counterparts of the library's ``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq``, design "simt" (float32 FMA on the CUDA cores;
bound by operations, 10·N²·64 FLOP a head at the 67 TF/s float32 peak). Each
counts its launches like `attention` (`attention_backward_dkv`,
`attention_backward_dq`). On the CPU the same Function runs the plain
versions: `attention_reference` with the log-sum-exp of its logits, and
`attention_backward_reference`, the plain dQ, dK and dV from the saved
log-sum-exp, which is also the card's oracle.
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
# K7-bwd's one design in both types (float32 FMA on the CUDA cores)
BACKWARD_DESIGN = "simt"


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


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """Each row's log-sum-exp (natural log) of the scaled logits ``q · kᵀ ·
    scale``, float32 ``[..., N]``: what the kernels save for the
    backward."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.logsumexp(logits, dim=-1)


def attention_backward_reference(q, k, v, o, do, lse, scale: float,
                                 di=None):
    """Plain dQ, dK and dV of ``o = attention(q, k, v, scale)`` for the
    output gradient `do`, from the saved row log-sum-exp `lse` (``[...,
    N]``): ``P = exp(q · kᵀ · scale − lse)``, ``dV = Pᵀ · dO``, ``dS = P ∘
    (dO · Vᵀ − di)`` with ``di = rowsum(dO ∘ O)`` (or `di` as given, as the
    kernels take it; `o` is then not read), ``dQ = scale · dS · K``, ``dK
    = scale · dSᵀ · Q``; in float32 (float64 stays float64), the gradients
    in the input dtype."""
    wide = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, dof = (t.to(wide) for t in (q, k, v, do))
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale
                  - lse.to(wide)[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    di = ((dof * o.to(wide)).sum(-1) if di is None else di.to(wide))
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - di[..., None])
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(*tensors) -> None:
    """Raise unless the card's kernels take `tensors`: equal
    ``[B, heads, N, head_dim]`` CUDA tensors of one float32 or bfloat16
    type, head_dim 64, contiguous and 16-byte aligned."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dim() != 4 or any(t.shape != q.shape for t in tensors):
        raise ValueError(f"q, k, v {[tuple(t.shape) for t in tensors]} must "
                         f"be equal [B, heads, N, head_dim]")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the attention kernel takes head_dim {HEAD_DIM}, "
                         f"got {q.shape[-1]}")
    if any(t.device != q.device or t.dtype != q.dtype for t in tensors):
        raise ValueError("q, k, v must share device and dtype")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("q, k, v must be contiguous and 16-byte aligned")
    _cuda.dtype_code(q)          # raises on a type no kernel takes


def _forward_kernel(q, k, v, scale, with_lse: bool):
    """The forward kernel's launch: the output and, `with_lse`, each row's
    log-sum-exp (else None)."""
    b, heads, n, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b * heads, n), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    lib = _cuda.library("vit_attention")
    design = DESIGNS[q.dtype]
    with torch.cuda.device(q.device):
        rc = getattr(lib, f"vit_attention_{design}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b * heads, n,
            float(scale), _cuda.stream_of(q))
    _cuda.check(lib, rc, "vit_attention")
    attention.launches += 1
    attention.shapes[(b, heads, n, d)] += 1
    attention.designs[(design, QUERY_TILE, KEY_TILE)] += 1
    return out, lse


def attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """`attention`'s output and each row's log-sum-exp (float32 ``[B,
    heads, N]``), as a train step's forward saves them: the kernel with its
    ``lse`` pointer on the card (checked as `attention` checks), the plain
    versions on the CPU. No autograd."""
    if _cuda.on_cpu(q):
        return (attention_reference(q, k, v, scale),
                attention_lse_reference(q, k, scale))
    _check(q, k, v)
    out, lse = _forward_kernel(q, k, v, scale, with_lse=True)
    return out, lse.view(q.shape[:-1])


class _Attention(torch.autograd.Function):
    """`attention` with a gradient: the forward saves each row's
    log-sum-exp, the backward is `attention_backward` (its plain version on
    the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = attention_with_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        grads = attention_backward(q, k, v, out, do.to(q.dtype).contiguous(),
                                   lse, ctx.scale)
        return (*grads, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """Non-causal softmax attention ``softmax(q · kᵀ · scale) · v`` over
    ``[B, heads, N, head_dim]`` → ``[B, heads, N, head_dim]``.

    CPU tensors take `attention_reference`; CUDA tensors launch the
    kernel's design for their type (bfloat16: "mma"; float32: "tf32x3";
    all three contiguous, of one shape, head_dim 64, 16-byte aligned) or
    raise. Where an input requires grad (autograd on), it is the
    ``autograd.Function`` whose backward is K7-bwd on the card.
    """
    cpu = _cuda.on_cpu(q)
    if not cpu:
        _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, scale)
    if cpu:
        return attention_reference(q, k, v, scale)
    return _forward_kernel(q, k, v, scale, with_lse=False)[0]


def _launch_backward(kind: str, q, k, v, do, lse, di, outs, scale) -> None:
    """One K7-bwd kernel's launch: `kind` "dkv" writes dK, dV into `outs`,
    "dq" dQ."""
    b, heads, n, d = q.shape
    lib = _cuda.library("vit_attention")
    with torch.cuda.device(q.device):
        rc = getattr(lib, f"vit_attention_bwd_{kind}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), *(t.data_ptr() for t in outs),
            b * heads, n, float(scale), _cuda.dtype_code(q),
            _cuda.stream_of(q))
    _cuda.check(lib, rc, f"vit_attention_bwd_{kind}")


def attention_backward_dkv(q, k, v, do, lse, di, scale):
    """dK and dV (K7-bwd's first kernel) from the saved row log-sum-exp
    `lse` and ``di = rowsum(dO ∘ O)``, float32 ``[B, heads, N]`` each."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_backward("dkv", q, k, v, do, lse, di, (dk, dv), scale)
    _count(attention_backward_dkv, q.shape)
    return dk, dv


def attention_backward_dq(q, k, v, do, lse, di, scale):
    """dQ (K7-bwd's second kernel), as `attention_backward_dkv`."""
    dq = torch.empty_like(q)
    _launch_backward("dq", q, k, v, do, lse, di, (dq,), scale)
    _count(attention_backward_dq, q.shape)
    return dq


def _count(wrapper, shape) -> None:
    wrapper.launches += 1
    wrapper.shapes[tuple(shape)] += 1
    wrapper.designs[(BACKWARD_DESIGN, QUERY_TILE, KEY_TILE)] += 1


def attention_backward(q, k, v, o, do, lse, scale):
    """dQ, dK and dV of ``o = attention(q, k, v, scale)`` for the output
    gradient `do`, from the forward's row log-sum-exp `lse` (float32
    ``[B, heads, N]``). CPU tensors take `attention_backward_reference`;
    CUDA tensors (as `attention` takes them, `o` and `do` too) form ``di =
    rowsum(dO ∘ O)`` in float32 and launch both K7-bwd kernels, or raise."""
    if _cuda.on_cpu(q):
        return attention_backward_reference(q, k, v, o, do, lse, scale)
    _check(q, k, v, o, do)
    if lse.shape != q.shape[:-1] or lse.dtype != torch.float32:
        raise ValueError(f"lse {lse.dtype} {tuple(lse.shape)} must be "
                         f"float32 {tuple(q.shape[:-1])}")
    if q.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    lse = lse.contiguous()
    di = (do.float() * o.float()).sum(-1)
    dk, dv = attention_backward_dkv(q, k, v, do, lse, di, scale)
    return attention_backward_dq(q, k, v, do, lse, di, scale), dk, dv


# launches of the kernels, in all, by (B, heads, N, head_dim) and by design
# ("mma" | "tf32x3" | "simt", queries of a block, keys a step)
for _wrapper in (attention, attention_backward_dkv, attention_backward_dq):
    _wrapper.launches = 0
    _wrapper.shapes = Counter()
    _wrapper.designs = Counter()
