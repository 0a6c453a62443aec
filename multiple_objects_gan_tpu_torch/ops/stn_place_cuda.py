"""K1-K3, the STN place-and-accumulate and its gradient: CUDA kernel
wrappers, plain versions, and the operators and autograd that pair them.

* K1 replaces the Pallas TPU kernel
  ``multiple_objects_gan_tpu/ops/stn_pallas.py:stn_place_multi_pallas``:
  per object ``Wy @ F @ Wx^T`` with the hat weights of its place affine,
  summed over objects. It is the operator ``mog::stn_place_multi``.
* K2 replaces ``stn_pallas.py:stn_place_multi_grad_pallas``, the backward
  of K1: per object ``Wy^T @ g @ Wx`` with the forward's own weights. It
  is the operator ``mog::stn_place_multi_grad``.
* K3 replaces the ``jax.custom_vjp`` of ``stn_pallas.py:_fused``:
  :class:`StnPlaceMulti`, ``mog::stn_place_multi``'s registered autograd,
  whose forward is K1 and backward K2, with no gradient for the boxes.

Both kernels are ``csrc/stn_place.cu`` (CUDA C++ for ``sm_90a``, bound with
ctypes), each in float32 and in bf16 (the bf16 train step and serving): in
bf16 the hat weights are rounded to bf16, the sums run in float32 and the
result is rounded once, and the plain versions round alike. The boxes are
float32 in either type. Their bound on the card is bytes: each input value
they need is read once and each output written once, with a few operations
per byte.
Both are one block per (batch, tile of channels), with the tile sized
from the map sides (:func:`place_tile`, :func:`grad_tile`; 16 channels at
the model's shapes) and every side at most :data:`MAX_SIDE`; each block
builds its weight tables once in shared memory. K1 reads only the input
rows that have taps (16-byte ``cp.async`` copies, every object's rows in
flight at once), adds the values inside each object's box to the tile's
sums in shared memory, and writes them with 16-byte stores. K2 stages the
tile's gradient planes in shared memory, then runs two separable passes
per object over the tap ranges the block derives from the weights.

:func:`stn_place_multi_nchw` is the entry the model calls, and
:func:`stn_place_multi_grad_nchw` K2's. Each calls its operator, which has
a CUDA implementation (the launch), a CPU implementation (the plain
version) and a fake one (shapes alone), so that ``torch.export`` records
the operator and a loaded program launches K1 on the card. Importing this
module (``multiple_objects_gan_tpu_torch.ops`` imports it) registers them.
On either device the place's output has a ``grad_fn`` whenever the
features require grad. Nothing else than CUDA and CPU tensors is
accepted and nothing falls back. Each kernel launch adds one to that
kernel's launch count, so a run can show that its path went through the
kernels; a trace calls only the fake implementations and counts nothing.
``FlopCounterMode`` counts each operator's products as its plain
version's einsums, on either device.
"""

from __future__ import annotations

import ctypes
import threading

import torch
from torch.autograd.function import once_differentiable
from torch.utils.flop_counter import register_flop_formula

from multiple_objects_gan_tpu_torch.ops import _build
from multiple_objects_gan_tpu_torch.ops.stn import place_weights

MAX_OBJECTS = 16    # csrc/stn_place.cu:kMaxObjects
MAX_SIDE = 64       # csrc/stn_place.cu:kMaxSide, K1's and K2's largest side
GRAD_TILE = 16      # K2's channels a block where the planes fit
GRAD_TILE_BYTES = 48 * 1024  # shared memory for a tile's planes, at most
MAX_GRAD_SMEM = 232448 - MAX_OBJECTS * 16  # csrc/stn_place.cu:kMaxGradSmem
PLACE_TILE = 16     # K1's channels a block where the planes fit
PLACE_STAGES = 3    # csrc/stn_place.cu:kStages, objects staged at once
# K1's output sums and float32 staging buffers for a tile, at most
PLACE_TILE_BYTES = 96 * 1024
MAX_PLACE_SMEM = 232448     # csrc/stn_place.cu:kMaxPlaceSmem
# the element types the kernels take, and their C entries' suffixes
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

_count_lock = threading.Lock()
_launches = {"place": 0, "grad": 0}


def launch_count() -> int:
    """K1 launches since the last :func:`reset_launch_count`."""
    return _launches["place"]


def grad_launch_count() -> int:
    """K2 launches since the last :func:`reset_launch_count`."""
    return _launches["grad"]


def reset_launch_count() -> None:
    """Set the K1 and K2 launch counts to 0."""
    with _count_lock:
        _launches["place"] = 0
        _launches["grad"] = 0


def _count(kernel: str) -> None:
    with _count_lock:
        _launches[kernel] += 1


# ------------------------------------------------------------ plain versions

# the plain K1's two products; a traced program that holds either has
# inlined the plain version instead of the operator
PLACE_EQUATIONS = ("boip,bocpq->bociq", "bociq,bojq->bcij")


def _weights(bbox: torch.Tensor, out_hw, in_hw, dtype):
    """The hat weights Wy (B, O, Ho, h) and Wx (B, O, Wo, w), computed in
    float32 and rounded to ``dtype``, in the type the plain versions sum
    in: float32 for bf16 and float32, float64 for float64."""
    b, o = bbox.shape[:2]
    wy, wx = place_weights(bbox.reshape(b * o, 4), out_hw, in_hw)
    acc = _acc_dtype(dtype)
    return (wy.reshape(b, o, out_hw[0], in_hw[0]).to(dtype).to(acc),
            wx.reshape(b, o, out_hw[1], in_hw[1]).to(dtype).to(acc))


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def stn_place_multi_plain(features: torch.Tensor, bbox: torch.Tensor,
                          out_hw: tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of K1, returned in the features' dtype.

    features (B, O, C, h, w), bbox (B, O, 4) -> (B, C, Ho, Wo): per object
    Wy @ F @ Wx^T with the hat weights of its place affine (computed in
    float32), summed over objects, as the Pallas kernel computes it. For
    bf16 features the weights are rounded to bf16, the products and sums
    run in float32, and the result is rounded to bf16 once, as K1 does.
    """
    hi, wi = features.shape[-2:]
    wy, wx = _weights(bbox, out_hw, (hi, wi), features.dtype)
    tmp = torch.einsum(PLACE_EQUATIONS[0], wy,
                       features.to(_acc_dtype(features.dtype)))
    out = torch.einsum(PLACE_EQUATIONS[1], tmp, wx)
    return out.to(features.dtype)


def stn_place_multi_grad_plain(grad: torch.Tensor, bbox: torch.Tensor,
                               in_hw: tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of K2, returned in the gradient's dtype.

    grad (B, C, Ho, Wo), bbox (B, O, 4) -> (B, O, C, h, w): per object
    Wy^T @ g @ Wx with the forward's own hat weights, the exact adjoint of
    :func:`stn_place_multi_plain`, rounded as it rounds.
    """
    wy, wx = _weights(bbox, grad.shape[-2:], in_hw, grad.dtype)
    tmp = torch.einsum("boip,bcij->bocpj", wy,
                       grad.to(_acc_dtype(grad.dtype)))
    out = torch.einsum("bocpj,bojq->bocpq", tmp, wx)
    return out.to(grad.dtype)


# ------------------------------------------------------------------ kernels


def _stage_elems(tile: int, in_hw, elem_size: int) -> int:
    """K1's staging buffer for one object, in elements: the tile's input
    planes rounded up to 16-byte chunks, and one chunk to spare
    (csrc/stn_place.cu:place_stage_elems)."""
    v = 16 // elem_size
    return -(-tile * in_hw[0] * in_hw[1] // v) * v + v


def place_smem_bytes(n_objects: int, tile: int, in_hw, out_hw,
                     elem_size: int) -> int:
    """K1's dynamic shared memory for a tile of channels in elements of
    ``elem_size`` bytes: every object's tables in 16-byte entries (each
    output row's and column's taps, the object's span and meta), the
    tile's output sums in float32 (rounded up to 16 bytes), a staging
    buffer for each of up to PLACE_STAGES objects, and each object's list
    of input rows with taps (csrc/stn_place.cu:place_smem_bytes)."""
    (hi, _), (ho, wo) = in_hw, out_hw
    return (16 * n_objects * (ho + wo + 2)
            + 4 * (-(-tile * ho * wo // 4) * 4)
            + min(n_objects, PLACE_STAGES) * _stage_elems(tile, in_hw,
                                                          elem_size)
            * elem_size
            + 4 * n_objects * hi)


def place_tile(in_hw, out_hw) -> int:
    """K1's channels a block: PLACE_TILE, halved until the tile's output
    sums and its PLACE_STAGES staging buffers, in float32, fit in
    PLACE_TILE_BYTES (16 at 16x16 and 15x15, 4 at 32x32, 1 at 64x64). The
    block's whole shared memory then stays within MAX_PLACE_SMEM for every
    side up to MAX_SIDE, 1..MAX_OBJECTS objects and either element type."""
    ho, wo = out_hw
    tile = PLACE_TILE
    while tile > 1 and 4 * tile * ho * wo + PLACE_STAGES * 4 * _stage_elems(
            tile, in_hw, 4) > PLACE_TILE_BYTES:
        tile //= 2
    return tile


def grad_smem_bytes(n_objects: int, tile: int, in_hw, out_hw) -> int:
    """K2's dynamic shared memory for a tile of channels: the tile's
    gradient planes, one object's row sums T and its output planes in
    float32, then every object's tables (csrc/stn_place.cu:grad_smem_words,
    in bytes)."""
    (hi, wi), (ho, wo) = in_hw, out_hw
    return 4 * (tile * (ho * (wo + wi) + hi * wi)
                + n_objects * (3 * (ho + wo) + 2 * (hi + wi) + 2 + 4 * hi))


def grad_tile(in_hw, out_hw) -> int:
    """K2's channels a block: GRAD_TILE, halved until the tile's planes
    fit in GRAD_TILE_BYTES (16 at the train step's shapes, 1 at 64 a
    side). The block's whole shared memory, tables included, then stays
    within MAX_GRAD_SMEM for every side up to MAX_SIDE."""
    tile = GRAD_TILE
    while tile > 1 and grad_smem_bytes(0, tile, in_hw, out_hw) \
            > GRAD_TILE_BYTES:
        tile //= 2
    return tile


def _check_sides(in_hw, out_hw, name: str) -> None:
    if max(*in_hw, *out_hw) > MAX_SIDE:
        raise ValueError(f"{name} takes maps of at most {MAX_SIDE} a side, "
                         f"got {tuple(in_hw)} and {tuple(out_hw)}")


def _check(x: torch.Tensor, bbox: torch.Tensor, n_objects: int,
           sides: tuple[int, ...]) -> None:
    """What both kernels take: float32 or bf16 values and float32 boxes,
    contiguous, on one device, boxes (B, O, 4) with 1..MAX_OBJECTS
    objects, every map side at least 1."""
    b, c = x.shape[0], x.shape[-3]
    if tuple(bbox.shape) != (b, n_objects, 4):
        raise ValueError(f"bbox must be {(b, n_objects, 4)}, got "
                         f"{tuple(bbox.shape)}")
    if x.dtype not in _SUFFIX or bbox.dtype != torch.float32:
        raise ValueError(f"the kernels take float32 or bfloat16 values and "
                         f"float32 boxes, got {x.dtype} and {bbox.dtype}")
    if bbox.device != x.device:
        raise ValueError(f"bbox on {bbox.device}, features on {x.device}")
    if not (x.is_contiguous() and bbox.is_contiguous()):
        raise ValueError("the tensors must be contiguous")
    if not 1 <= n_objects <= MAX_OBJECTS:
        raise ValueError(f"1..{MAX_OBJECTS} objects supported, got "
                         f"{n_objects}")
    if min(b, c, *sides) < 1 or b * c >= 2 ** 31:
        raise ValueError(f"unsupported shape {tuple(x.shape)} with sides "
                         f"{sides}")


def _check_device(t: torch.Tensor, name: str) -> None:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")


_fns: dict = {}     # C entry name -> its ctypes function, typed once


def _kernel(symbol: str, n_ints: int):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(_build.build("stn_place").lib, symbol)
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _launch(symbol: str, kernel: str, args, device) -> None:
    fn = _kernel(symbol, len(args) - 3)
    if device.index == torch.cuda.current_device():
        err = fn(*args, _build.current_stream(device.index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, _build.current_stream(device.index))
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed with CUDA error {err}")
    _count(kernel)


def _place_cuda(features: torch.Tensor, bbox: torch.Tensor,
                out_hw) -> torch.Tensor:
    """Launch K1: ``mog::stn_place_multi``'s CUDA implementation."""
    if features.dim() != 5:
        raise ValueError(f"features must be (B, O, C, h, w), got "
                         f"{tuple(features.shape)}")
    b, o, c, hi, wi = features.shape
    ho, wo = (int(v) for v in out_hw)
    _check(features, bbox, o, (hi, wi, ho, wo))
    _check_sides((hi, wi), (ho, wo), "K1")
    out = torch.empty((b, c, ho, wo), dtype=features.dtype,
                      device=features.device)
    _launch(f"stn_place_multi_{_SUFFIX[features.dtype]}", "place",
            (features.data_ptr(), bbox.data_ptr(), out.data_ptr(),
             b, o, c, hi, wi, ho, wo, place_tile((hi, wi), (ho, wo))),
            features.device)
    return out


def _grad_cuda(grad: torch.Tensor, bbox: torch.Tensor,
               in_hw) -> torch.Tensor:
    """Launch K2: ``mog::stn_place_multi_grad``'s CUDA implementation."""
    if grad.dim() != 4 or bbox.dim() != 3:
        raise ValueError(f"grad must be (B, C, Ho, Wo) and bbox (B, O, 4), "
                         f"got {tuple(grad.shape)} and {tuple(bbox.shape)}")
    b, c, ho, wo = grad.shape
    o = bbox.shape[1]
    hi, wi = (int(v) for v in in_hw)
    _check(grad, bbox, o, (hi, wi, ho, wo))
    _check_sides((hi, wi), (ho, wo), "K2")
    out = torch.empty((b, o, c, hi, wi), dtype=grad.dtype,
                      device=grad.device)
    _launch(f"stn_place_multi_grad_{_SUFFIX[grad.dtype]}", "grad",
            (grad.data_ptr(), bbox.data_ptr(), out.data_ptr(),
             b, o, c, hi, wi, ho, wo, grad_tile((hi, wi), (ho, wo))),
            grad.device)
    return out


# ---------------------------------------------------------------- operators

# K1 and K2 as operators of PyTorch's dispatcher, defined with the
# low-level Library (its dispatch costs the host less than custom_op's):
# a trace (torch.export, FakeTensor) records the operator itself from its
# fake implementation, and a program that calls it reaches the kernel on
# the card. Registering builds nothing: the library is built at the first
# CUDA launch (ops/_build.py).
_LIB = torch.library.Library("mog", "DEF")
_LIB.define("stn_place_multi(Tensor features, Tensor bbox, int[2] out_hw) "
            "-> Tensor")
_LIB.define("stn_place_multi_grad(Tensor grad, Tensor bbox, int[2] in_hw) "
            "-> Tensor")
PLACE_OP = torch.ops.mog.stn_place_multi.default
GRAD_OP = torch.ops.mog.stn_place_multi_grad.default


# The implementations look their functions up when called, so that a test
# or chip_smoke.py can wrap them.
def _place_on_cpu(features, bbox, out_hw):
    return stn_place_multi_plain(features, bbox, tuple(out_hw))


def _place_on_cuda(features, bbox, out_hw):
    return _place_cuda(features, bbox, out_hw)


def _grad_on_cpu(grad, bbox, in_hw):
    return stn_place_multi_grad_plain(grad, bbox, tuple(in_hw))


def _grad_on_cuda(grad, bbox, in_hw):
    return _grad_cuda(grad, bbox, in_hw)


def _place_fake(features, bbox, out_hw):
    if features.dim() != 5 or bbox.dim() != 3:
        raise ValueError(f"features must be (B, O, C, h, w) and bbox "
                         f"(B, O, 4), got {tuple(features.shape)} and "
                         f"{tuple(bbox.shape)}")
    return features.new_empty((features.shape[0], features.shape[2],
                               out_hw[0], out_hw[1]))


def _grad_fake(grad, bbox, in_hw):
    if grad.dim() != 4 or bbox.dim() != 3:
        raise ValueError(f"grad must be (B, C, Ho, Wo) and bbox (B, O, 4), "
                         f"got {tuple(grad.shape)} and {tuple(bbox.shape)}")
    return grad.new_empty((grad.shape[0], bbox.shape[1], grad.shape[1],
                           in_hw[0], in_hw[1]))


class StnPlaceMulti(torch.autograd.Function):
    """K3: ``mog::stn_place_multi``'s registered autograd.

    Forward is the operator below autograd (K1, or its plain version on
    the CPU), backward :func:`stn_place_multi_grad_nchw` (K2, or its plain
    version), both in the features' dtype, so the gradient keeps it (bf16
    in the bf16 step). Gradients flow to the features only; the boxes are
    data, as in the reference and the JAX package's ``custom_vjp``. Saves
    only the boxes and the input size.
    """

    @staticmethod
    def forward(ctx, features, bbox, out_hw):
        ctx.save_for_backward(bbox)
        ctx.in_hw = tuple(features.shape[-2:])
        with torch._C._AutoDispatchBelowAutograd():
            return PLACE_OP(features, bbox, out_hw)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (bbox,) = ctx.saved_tensors
        return (stn_place_multi_grad_nchw(grad.contiguous(), bbox,
                                          ctx.in_hw), None, None)


def _place_autograd(features, bbox, out_hw):
    if torch.is_grad_enabled() and features.requires_grad:
        return StnPlaceMulti.apply(features, bbox, out_hw)
    with torch._C._AutoDispatchBelowAutograd():
        return PLACE_OP(features, bbox, out_hw)


def _grad_autograd(grad, bbox, in_hw):
    """K2 has no backward of its own. On the card it refuses a ``grad``
    that requires grad while grad mode is on, rather than return a result
    cut from the graph; on the CPU that case runs the plain version under
    autograd."""
    if torch.is_grad_enabled() and grad.requires_grad:
        if grad.device.type != "cpu":
            raise RuntimeError("stn_place_multi_grad_nchw is not "
                               "differentiable on the card; it runs inside "
                               "StnPlaceMulti's backward")
        return stn_place_multi_grad_plain(grad, bbox, tuple(in_hw))
    with torch._C._AutoDispatchBelowAutograd():
        return GRAD_OP(grad, bbox, in_hw)


_LIB.impl("stn_place_multi", _place_on_cpu, "CPU")
_LIB.impl("stn_place_multi", _place_on_cuda, "CUDA")
_LIB.impl("stn_place_multi", _place_autograd, "Autograd")
_LIB.impl("stn_place_multi_grad", _grad_on_cpu, "CPU")
_LIB.impl("stn_place_multi_grad", _grad_on_cuda, "CUDA")
_LIB.impl("stn_place_multi_grad", _grad_autograd, "Autograd")
torch.library.register_fake("mog::stn_place_multi", _place_fake, lib=_LIB)
torch.library.register_fake("mog::stn_place_multi_grad", _grad_fake,
                            lib=_LIB)


@register_flop_formula(torch.ops.mog.stn_place_multi)
def _place_flops(features_shape, bbox_shape, out_hw, *args, **kwargs):
    """K1's products, as its plain version's einsums count them."""
    b, o, c, hi, wi = features_shape
    return 2 * b * o * c * out_hw[0] * wi * (hi + out_hw[1])


@register_flop_formula(torch.ops.mog.stn_place_multi_grad)
def _grad_flops(grad_shape, bbox_shape, in_hw, *args, **kwargs):
    """K2's products, as its plain version's einsums count them."""
    b, c, ho, wo = grad_shape
    return 2 * b * bbox_shape[1] * c * in_hw[0] * wo * (ho + in_hw[1])


def stn_place_multi_grad_nchw(grad: torch.Tensor, bbox: torch.Tensor,
                              in_hw: tuple[int, int]) -> torch.Tensor:
    """K2: grad (B, C, Ho, Wo) f32 or bf16, bbox (B, O, 4) f32 ->
    (B, O, C, h, w) in the gradient's dtype, through
    ``mog::stn_place_multi_grad``.

    A CUDA tensor launches the kernel on the current stream (or raises); a
    CPU tensor runs :func:`stn_place_multi_grad_plain`. On the card it is
    not differentiable (:func:`_grad_autograd`).
    """
    _check_device(grad, "stn_place_multi_grad_nchw")
    return GRAD_OP(grad, bbox, [int(v) for v in in_hw])


def stn_place_multi_nchw(features: torch.Tensor, bbox: torch.Tensor,
                         out_hw: tuple[int, int]) -> torch.Tensor:
    """features (B, O, C, h, w), bbox (B, O, 4) -> (B, C, Ho, Wo), through
    ``mog::stn_place_multi``.

    K1 on the current stream for a CUDA tensor (float32 or bf16, or it
    raises), the plain version for a CPU tensor. The output has the
    features' dtype. The boxes are detached; the output has a ``grad_fn``
    (:class:`StnPlaceMulti`) whenever the features require grad.
    """
    _check_device(features, "stn_place_multi_nchw")
    return PLACE_OP(features, bbox.detach(), [int(v) for v in out_hw])
