"""JPEG on the card: a ctypes binding to nvjpeg, and the device dispatch of
the port's image I/O.

:func:`decode_batch` and :func:`encode` take nvjpeg for a CUDA device and
the numpy codec of ``data/jpeg.py`` for the CPU. Neither gives way to the
other: on the card a missing ``libnvjpeg``, a failed status or a file the
codec refuses raises with the file's name, and no image is left as zeros
(the JAX package's ``native_loader.decode_batch`` leaves zeros; its
reference ``__getitem__`` raises, and the port follows the reference).

nvjpeg (``libnvjpeg.so.12`` of the CUDA toolkit, found under
``$CUDA_HOME`` or ``/usr/local/cuda`` as ``ops/_build.py`` finds
``nvcc``) decodes with ``nvjpegDecode`` into an interleaved RGB tensor
(``NVJPEG_OUTPUT_RGBI``) on torch's current stream, with one
``nvjpegJpegState`` per thread (the ``Loader``'s prefetch thread decodes)
and the stream synchronised after each image, since the state's host
buffers are refilled by the next decode. The ``Loader``'s thread reads on
a stream of its own, so that synchronize waits for its decodes alone,
not for the train step. It encodes with ``nvjpegEncodeImage`` at quality
75 and 4:2:0, PIL's defaults. Before a file reaches nvjpeg its markers
are read by ``jpeg.probe_jpeg``, so the card takes the files the numpy
codec takes and refuses the same ones (progressive, arithmetic-coded,
12-bit, CMYK, a file without its EOI). What the card does not refuse: a
scan whose entropy-coded data is garbled with its markers intact decodes
under nvjpeg, which does not check that data, while the numpy decoder
raises on it. nvjpeg's IDCT and chroma upsampling are not libjpeg's: its
pixels are within a few levels of PIL's, not equal to them.

nvjpeg is a library decoder for host I/O; no TPU kernel stands behind it.
The resize that follows a decode is ``data/png.py``'s PIL-exact bilinear,
on the device where the pixels are (:func:`decode_resized`).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from multiple_objects_gan_tpu_torch.data.jpeg import (
    DEFAULT_QUALITY, decode_jpeg, encode_jpeg, probe_jpeg)
from multiple_objects_gan_tpu_torch.data.png import (
    resize_bilinear_batch, resize_bilinear_tensor)

MAX_COMPONENT = 4                 # NVJPEG_MAX_COMPONENT
OUTPUT_RGBI = 5                   # nvjpegOutputFormat_t
INPUT_RGBI = 5                    # nvjpegInputFormat_t
CSS_420 = 2                       # nvjpegChromaSubsampling_t
STATUS = {0: "SUCCESS", 1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER",
          3: "BAD_JPEG", 4: "JPEG_NOT_SUPPORTED", 5: "ALLOCATOR_FAILURE",
          6: "EXECUTION_FAILED", 7: "ARCH_MISMATCH", 8: "INTERNAL_ERROR",
          9: "IMPLEMENTATION_NOT_SUPPORTED", 10: "INCOMPLETE_BITSTREAM"}
LIB_NAME = "libnvjpeg.so.12"


class Image(ctypes.Structure):
    """nvjpegImage_t: a pointer and a pitch per plane (RGBI uses plane 0)."""
    _fields_ = [("channel", ctypes.c_void_p * MAX_COMPONENT),
                ("pitch", ctypes.c_size_t * MAX_COMPONENT)]


class NvjpegError(RuntimeError):
    pass


def library_candidates() -> list[str]:
    """Where ``libnvjpeg.so.12`` is looked for, in order."""
    homes = [os.environ.get("CUDA_HOME") or "", "/usr/local/cuda"]
    out = []
    for home in homes:
        if not home:
            continue
        for sub in ("lib64", "lib", "targets/x86_64-linux/lib"):
            out.append(os.path.join(home, sub, LIB_NAME))
    return out


_lock = threading.Lock()
_lib = None
_handle = None
_local = threading.local()


def _load():
    """The library and one nvjpeg handle for the process (thread-safe)."""
    global _lib, _handle
    with _lock:
        if _lib is None:
            path = next((p for p in library_candidates()
                         if os.path.isfile(p)), None)
            if path is None:
                raise NvjpegError(
                    f"{LIB_NAME} not found (looked in "
                    f"{', '.join(library_candidates())}): the card decodes "
                    "JPEGs with the CUDA toolkit's nvjpeg")
            lib = ctypes.CDLL(path)
            vp, ip = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
            sp = ctypes.POINTER(ctypes.c_size_t)
            for name, args in {
                    "nvjpegCreateSimple": [ctypes.POINTER(vp)],
                    "nvjpegJpegStateCreate": [vp, ctypes.POINTER(vp)],
                    "nvjpegJpegStateDestroy": [vp],
                    "nvjpegEncoderStateDestroy": [vp],
                    "nvjpegEncoderParamsDestroy": [vp],
                    "nvjpegGetImageInfo": [vp, ctypes.c_char_p,
                                           ctypes.c_size_t, ip, ip, ip, ip],
                    "nvjpegDecode": [vp, vp, ctypes.c_char_p, ctypes.c_size_t,
                                     ctypes.c_int, ctypes.POINTER(Image), vp],
                    "nvjpegEncoderStateCreate": [vp, ctypes.POINTER(vp), vp],
                    "nvjpegEncoderParamsCreate": [vp, ctypes.POINTER(vp), vp],
                    "nvjpegEncoderParamsSetQuality": [vp, ctypes.c_int, vp],
                    "nvjpegEncoderParamsSetSamplingFactors": [
                        vp, ctypes.c_int, vp],
                    "nvjpegEncodeImage": [vp, vp, vp, ctypes.POINTER(Image),
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, vp],
                    "nvjpegEncodeRetrieveBitstream": [vp, vp, vp, sp, vp]
                    }.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            handle = vp()
            _check(lib.nvjpegCreateSimple(ctypes.byref(handle)),
                   "nvjpegCreateSimple")
            _lib, _handle = lib, handle
        return _lib, _handle


def _check(status: int, what: str, name: str = "") -> None:
    if status != 0:
        where = f"{name}: " if name else ""
        raise NvjpegError(f"{where}{what} failed with NVJPEG_STATUS_"
                          f"{STATUS.get(status, status)}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


class _Owned:
    """nvjpeg objects of one thread, destroyed when the thread's locals go
    (the ``Loader`` starts a thread an epoch)."""

    def __init__(self, objs, destroy):
        self.objs, self.destroy = objs, destroy

    def __del__(self):
        for obj, fn in zip(self.objs, self.destroy):
            fn(obj)


def _thread_state(kind: str, create, destroy):
    """This thread's nvjpeg objects ``kind``, made by ``create`` once."""
    owned = getattr(_local, kind, None)
    if owned is None:
        owned = _Owned(create(), destroy)
        setattr(_local, kind, owned)
    return owned.objs


def decode_nvjpeg(data: bytes, name: str, device) -> torch.Tensor:
    """One JPEG decoded by nvjpeg into (H, W, 3) uint8 on ``device``."""
    probe_jpeg(data, name)
    lib, handle = _load()
    device = torch.device(device)

    def new_state():
        st = ctypes.c_void_p()
        _check(lib.nvjpegJpegStateCreate(handle, ctypes.byref(st)),
               "nvjpegJpegStateCreate")
        return [st]

    state, = _thread_state("jpeg_state", new_state,
                           [lib.nvjpegJpegStateDestroy])
    ncomp, css = ctypes.c_int(), ctypes.c_int()
    widths = (ctypes.c_int * MAX_COMPONENT)()
    heights = (ctypes.c_int * MAX_COMPONENT)()
    _check(lib.nvjpegGetImageInfo(handle, data, len(data),
                                  ctypes.byref(ncomp), ctypes.byref(css),
                                  widths, heights),
           "nvjpegGetImageInfo", name)
    h, w = heights[0], widths[0]
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=device)
    img = Image()
    img.channel[0] = out.data_ptr()
    img.pitch[0] = w * 3
    _check(lib.nvjpegDecode(handle, state, data, len(data), OUTPUT_RGBI,
                            ctypes.byref(img), _stream(device)),
           "nvjpegDecode", name)
    # the state's host buffers are refilled by the next decode while this
    # one's copy to the card may still wait behind the stream's queue:
    # wait for it here
    torch.cuda.current_stream(device).synchronize()
    return out


def encode_nvjpeg(u8: torch.Tensor, device=None) -> bytes:
    """(H, W, 3) uint8 RGB -> JPEG bytes from nvjpeg's encoder at quality
    75 and 4:2:0, on ``device`` (default: the tensor's, a card)."""
    lib, handle = _load()
    if u8.dtype != torch.uint8 or u8.ndim != 3 or u8.shape[-1] != 3:
        raise ValueError(f"encode on the card takes (H, W, 3) uint8, got "
                         f"{tuple(u8.shape)} {u8.dtype}")
    device = torch.device(device or u8.device)
    stream = _stream(device)
    u8 = u8.to(device).contiguous()

    def new_encoder():
        st, params = ctypes.c_void_p(), ctypes.c_void_p()
        _check(lib.nvjpegEncoderStateCreate(handle, ctypes.byref(st),
                                            stream),
               "nvjpegEncoderStateCreate")
        _check(lib.nvjpegEncoderParamsCreate(handle, ctypes.byref(params),
                                             stream),
               "nvjpegEncoderParamsCreate")
        _check(lib.nvjpegEncoderParamsSetSamplingFactors(params, CSS_420,
                                                         stream),
               "nvjpegEncoderParamsSetSamplingFactors")
        _check(lib.nvjpegEncoderParamsSetQuality(params, DEFAULT_QUALITY,
                                                 stream),
               "nvjpegEncoderParamsSetQuality")
        return [st, params]

    st, params = _thread_state(
        "encoder", new_encoder, [lib.nvjpegEncoderStateDestroy,
                                 lib.nvjpegEncoderParamsDestroy])
    h, w = int(u8.shape[0]), int(u8.shape[1])
    img = Image()
    img.channel[0] = u8.data_ptr()
    img.pitch[0] = w * 3
    _check(lib.nvjpegEncodeImage(handle, st, params, ctypes.byref(img),
                                 INPUT_RGBI, w, h, stream),
           "nvjpegEncodeImage")
    length = ctypes.c_size_t(0)
    _check(lib.nvjpegEncodeRetrieveBitstream(handle, st, None,
                                             ctypes.byref(length), stream),
           "nvjpegEncodeRetrieveBitstream")
    torch.cuda.current_stream(device).synchronize()
    buf = (ctypes.c_ubyte * length.value)()
    _check(lib.nvjpegEncodeRetrieveBitstream(handle, st, buf,
                                             ctypes.byref(length), stream),
           "nvjpegEncodeRetrieveBitstream")
    torch.cuda.current_stream(device).synchronize()
    return bytes(buf[:length.value])


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def decode_batch(paths, device="cpu") -> list:
    """Each file of ``paths`` decoded to (H, W, 3) uint8 RGB: numpy arrays
    from ``data/jpeg.py`` on the CPU, tensors on a CUDA ``device`` from
    nvjpeg."""
    device = torch.device(device)
    if device.type != "cuda":
        return [decode_jpeg(_read(p), p) for p in paths]
    return [decode_nvjpeg(_read(p), p, device) for p in paths]


def decode_resized(paths, size: int, device="cpu"):
    """The files of ``paths`` decoded and resized to ``size`` x ``size`` with
    PIL's bilinear filter (``Image.open(p).convert("RGB").resize((size,
    size), Image.BILINEAR)``), stacked: (N, size, size, 3) uint8, a numpy
    array on the CPU, a tensor on a CUDA ``device``. Images that share a
    size are resized together."""
    device = torch.device(device)
    imgs = decode_batch(paths, device)
    cuda = device.type == "cuda"
    out = (torch.empty((len(imgs), size, size, 3), dtype=torch.uint8,
                       device=device) if cuda else
           np.empty((len(imgs), size, size, 3), np.uint8))
    groups: dict = {}
    for i, img in enumerate(imgs):
        groups.setdefault(tuple(img.shape), []).append(i)
    for shape, idx in groups.items():
        if shape[:2] == (size, size):
            for i in idx:
                out[i] = imgs[i]
            continue
        if cuda:
            stack = torch.stack([imgs[i] for i in idx])
            out[torch.tensor(idx, device=device)] = resize_bilinear_tensor(
                stack, (size, size))
        else:
            out[idx] = resize_bilinear_batch(np.stack([imgs[i] for i in idx]),
                                             (size, size))
    return out


def encode(path: str, u8, device="cpu") -> None:
    """Write the uint8 (H, W, 3) image ``u8`` to ``path`` as a JPEG:
    ``data/jpeg.py``'s encoder (PIL's ``save`` at its defaults) on the CPU,
    nvjpeg's for a CUDA ``device``."""
    device = torch.device(device)
    if device.type == "cuda":
        t = (u8 if isinstance(u8, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(u8)))
        data = encode_nvjpeg(t, device)
    else:
        data = encode_jpeg(np.asarray(u8))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
