"""The port's float32 contract: a float32 forward computes in full float32.

PyTorch runs a float32 cuDNN convolution in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits. Every model's ``forward`` enters `full_float32` when it
computes in float32, so that the 2D trunk, the stride-2 and transposed 3D
convs, the 1×1 and depthwise convs and the Linear layers compute what the
CPU reference computes, whatever the process-global flags say. The
hand-written float32 kernels on the tensor cores (K2, K3's "stencil", K7)
never take one TF32 product: they split each operand into a TF32 high part
and a TF32 remainder (`tf32_split`) and sum three products, lo·hi + hi·lo +
hi·hi ("3xTF32"), which keeps a product to about 2⁻²² of itself.

bfloat16 is the other half of the contract: ``create_model(...,
dtype=torch.bfloat16)`` casts the conv, linear and attention parameters and
keeps in float32 what the JAX package keeps and computes with in float32
(``models.keeps_float32``): every BatchNorm's weight, bias and running
statistics, so that the folded BatchNorm is the float32 model's; every
LayerNorm's weight and bias, which normalise a float32 input and round once
to bfloat16 (flax's ``LayerNorm(dtype=bfloat16)``; the card's
``F.layer_norm`` takes float32 weights with a float32 input, not with a
bfloat16 one); DINOv2's ``cls_token``, ``pos_embed`` and LayerScale
``gamma``, so that its token stream and residual adds are float32 as JAX's
type promotion makes them; and CFNet's ``gamma_s*`` / ``beta_s*``, which
set its search ranges in float32.

In training, bfloat16 is a view of the float32 model's parameters
(``models.bfloat16_view``): the model computes as the bfloat16 model does
while its float32 parameters stay the masters, and `compute_dtype` refuses
to train a cast model, which has none.
"""

from __future__ import annotations

import contextlib

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32 (10 fraction bits), to nearest with ties
    away from zero, as the card's ``cvt.rna.tf32.f32`` rounds: half a TF32
    unit added to the magnitude's bits, the 13 low bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)``: x's TF32 high part and its remainder rounded to TF32,
    as the 3xTF32 kernels split an operand; ``hi + lo`` is x to about 2⁻²²
    of |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def compute_dtype(weight: torch.Tensor, training: bool) -> torch.dtype:
    """The type a model computes in: its `weight`'s. In train mode a
    bfloat16 weight must be a view of a float32 master (a plain tensor under
    ``torch.func.functional_call``); a bfloat16 parameter is a cast model's
    (``create_model(..., dtype=torch.bfloat16)``), which has no masters to
    update, and raises."""
    if (training and weight.dtype == torch.bfloat16
            and isinstance(weight, torch.nn.Parameter)):
        raise NotImplementedError(
            "bfloat16 training takes the float32 model, whose parameters "
            "are the masters, and runs it on a bfloat16 view "
            "(trainer.make_train_step(model, config, dtype=torch.bfloat16), "
            "models.bfloat16_view); this model's parameters are bfloat16 "
            "themselves (create_model(..., dtype=torch.bfloat16) builds the "
            "eval model)")
    return weight.dtype


@contextlib.contextmanager
def full_float32(enabled: bool = True):
    """Within it, cuDNN's convolutions and cuBLAS's matrix products take no
    TF32 (``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` False); on exit, also by an
    exception, the caller's settings are back. With ``enabled=False`` it
    changes nothing."""
    if not enabled:
        yield
        return
    restore = _tf32_restorer()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        restore()


def _tf32_restorer():
    """A function that puts the TF32 settings back as they are now, through
    the API they were set with. PyTorch (2.9 and later) refuses to read the
    two flags once a caller has set TF32 per operator
    (``torch.backends.cudnn.conv.fp32_precision``, ...), and refuses to read
    the float32 matmul precision once its backends disagree; each is saved
    where it can be read."""
    backends = torch.backends
    try:
        cudnn = backends.cudnn.allow_tf32
        matmul = backends.cuda.matmul.allow_tf32
    except RuntimeError:                       # set per operator
        per_op = (backends.cudnn.conv.fp32_precision,
                  backends.cudnn.rnn.fp32_precision,
                  backends.cuda.matmul.fp32_precision)

        def restore_per_op():
            (backends.cudnn.conv.fp32_precision,
             backends.cudnn.rnn.fp32_precision,
             backends.cuda.matmul.fp32_precision) = per_op
        return restore_per_op
    try:
        precision = torch.get_float32_matmul_precision()
    except RuntimeError:                       # its backends disagree
        precision = None

    def restore():
        backends.cudnn.allow_tf32 = cudnn
        backends.cuda.matmul.allow_tf32 = matmul
        if precision is not None:
            torch.set_float32_matmul_precision(precision)
    return restore
