"""Gradient compression for the collective wire format.

The port of ``horovod_tpu/ops/compression.py``: a ``Compression``
namespace whose members expose ``compress(tensor) -> (tensor, ctx)`` and
``decompress(tensor, ctx)`` (Horovod's ``horovod/torch/compression.py``
shape), plus the bucket-level ``compress_flat`` / ``decompress_flat`` /
``roundtrip`` / ``wire_bytes`` the fusion pipeline talks to.

Two families, told apart by whether the wire format survives a reduction
in flight:

* **Cast compressors** (``bf16``, its alias ``fp16``, and IEEE
  ``float16``): a dtype cast. Sums of cast values are meaningful, so the
  collective itself runs at the wire dtype.
* **Chunked quantizers** (``fp8_e4m3``, ``fp8_e5m2``, ``int8``): each chunk
  of ``chunk`` elements along the last axis is scaled by its own fp32
  scale (its absmax mapped onto the format's largest value) before
  narrowing. Values under different scales cannot be summed on the wire,
  so ``chunked = True`` routes them through exchange-then-reduce
  collectives (``ops/fusion.py``).

Non-float tensors are never narrowed: they pass through bit for bit with
no scales. The quantizer is plain PyTorch, so the same code runs on the
CPU and on the card and gives the same bits on both.
"""

import torch
import torch.nn.functional as F


def _floating(dtype):
    return dtype.is_floating_point


class NoneCompressor:
    """Pass-through (Horovod's ``NoneCompressor``)."""

    name = "none"
    chunked = False

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        del ctx
        return tensor


class _CastCompressor:
    """Cast floating tensors to a narrow wire dtype for the collective and
    back after it (Horovod's ``FP16Compressor``). The wire format is
    reducible: collectives may sum at the wire dtype."""

    chunked = False

    def __init__(self, wire_dtype, name):
        self.wire_dtype = wire_dtype
        self.name = name

    def __repr__(self):
        return f"_CastCompressor({self.name})"

    def compress(self, tensor):
        dtype = tensor.dtype
        if _floating(dtype) and dtype != self.wire_dtype:
            return tensor.to(self.wire_dtype), dtype
        return tensor, None

    def decompress(self, tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)

    # the bucket-level interface shared with ChunkedQuantizer; a cast wire
    # has no scales

    def compress_flat(self, flat):
        """``flat [..., n] -> (wire [..., n], scales=None)``."""
        if not _floating(flat.dtype):
            return flat, None
        return flat.to(self.wire_dtype), None

    def decompress_flat(self, wire, scales, dtype, n=None):
        del scales
        out = wire.to(dtype)
        if n is not None and out.shape[-1] != n:
            out = out[..., :n]
        return out

    def roundtrip(self, flat):
        """``(wire, scales, dequantized)``: the dequantized view feeds the
        error-feedback residual ``flat - dequantized``."""
        wire, _ = self.compress_flat(flat)
        return wire, None, wire.to(flat.dtype)

    def wire_bytes(self, n_elements, logical_dtype):
        """Bytes on the interconnect for ``n_elements`` of
        ``logical_dtype`` (non-float tensors ride uncompressed)."""
        if not _floating(logical_dtype):
            return int(n_elements) * logical_dtype.itemsize
        return int(n_elements) * self.wire_dtype.itemsize


# Elements per fp32 scale: the scales cost 4/256 = 1.6 % of the logical
# bytes, and a gradient spike coarsens only its own chunk.
DEFAULT_CHUNK = 256


class ChunkedQuantizer:
    """Narrow wire dtype plus one fp32 scale per ``chunk`` elements.

    ``compress_flat(flat [..., n]) -> (wire [..., n_pad], scales [..., c])``
    chunks along the LAST axis only: leading axes (the ``[world, shard]``
    rows of the reduce-scatter exchange) are kept, so no chunk straddles
    two ranks' rows and each destination decodes its rows from the scales
    that came with them. ``n_pad`` rounds ``n`` up to a chunk multiple;
    ``decompress_flat(..., n=n)`` slices the pad back off."""

    chunked = True

    def __init__(self, wire_dtype, range_max, name, chunk=DEFAULT_CHUNK,
                 integer=False):
        self.wire_dtype = wire_dtype
        self.range_max = float(range_max)
        self.name = name
        self.chunk = int(chunk)
        self.integer = integer

    def __repr__(self):
        return f"ChunkedQuantizer({self.name}, chunk={self.chunk})"

    def _padded(self, n):
        return n + (-n) % self.chunk

    def for_length(self, n):
        """This quantizer with the chunk clamped to a payload of ``n``
        elements, so a shard shorter than the chunk pays no chunk padding
        on every row. Both ends of a collective derive it from the same
        static shard size."""
        if n >= self.chunk:
            return self
        return ChunkedQuantizer(self.wire_dtype, self.range_max, self.name,
                                chunk=max(1, int(n)), integer=self.integer)

    def compress_flat(self, flat):
        wire, scales, _ = self._quantize(flat, want_dequant=False)
        return wire, scales

    def roundtrip(self, flat):
        """``(wire, scales, dequantized)`` in one pass."""
        return self._quantize(flat, want_dequant=True)

    def _quantize(self, flat, want_dequant):
        if not _floating(flat.dtype):
            return flat, None, flat  # never narrowed: bit-exact passthrough
        n = flat.shape[-1]
        x = flat.float()
        pad = self._padded(n) - n
        if pad:
            x = F.pad(x, (0, pad))
        chunks = x.reshape(x.shape[:-1] + (-1, self.chunk))
        absmax = chunks.abs().amax(dim=-1)
        # a zero chunk keeps scale 1, so 0 / scale stays 0. The divisor
        # is a tensor on the chunks' device: CUDA divides by a host scalar
        # as a multiply by its reciprocal, which can land one ulp off the
        # quotient the CPU (and the JAX package) computes
        range_max = absmax.new_full((), self.range_max)
        scales = torch.where(absmax > 0.0, absmax / range_max,
                             torch.ones_like(absmax))
        scaled = chunks / scales[..., None]
        if self.integer:
            q = torch.clamp(torch.round(scaled), -self.range_max,
                            self.range_max)
            wire = q.to(self.wire_dtype)
        else:
            wire = scaled.to(self.wire_dtype)
        wire = wire.reshape(x.shape)
        deq = None
        if want_dequant:
            deq = wire.float().reshape(chunks.shape) * scales[..., None]
            deq = deq.reshape(x.shape)[..., :n].to(flat.dtype)
        return wire, scales, deq

    def decompress_flat(self, wire, scales, dtype, n=None):
        """Inverse of ``compress_flat``: ``wire [..., n_pad]`` and
        ``scales [..., c]`` back to ``[..., n]`` at ``dtype``."""
        if scales is None:  # non-float passthrough
            return wire if n is None else wire[..., :n]
        chunks = wire.float().reshape(wire.shape[:-1] + (-1, self.chunk))
        out = (chunks * scales[..., None]).reshape(wire.shape)
        if n is not None:
            out = out[..., :n]
        return out.to(dtype)

    def wire_bytes(self, n_elements, logical_dtype):
        """Interconnect bytes for ``n_elements`` of ``logical_dtype``: the
        padded payload plus its fp32 scales (non-float tensors pass
        through at full width)."""
        if not _floating(logical_dtype):
            return int(n_elements) * logical_dtype.itemsize
        n_pad = self._padded(int(n_elements))
        return n_pad * self.wire_dtype.itemsize + (n_pad // self.chunk) * 4

    # the single-tensor interface of the namespace; ctx carries
    # (scales, dtype, n, shape)

    def compress(self, tensor):
        if not _floating(tensor.dtype):
            return tensor, None
        flat = tensor.reshape(-1)
        wire, scales = self.compress_flat(flat)
        return wire, (scales, tensor.dtype, flat.shape[-1], tensor.shape)

    def decompress(self, tensor, ctx):
        if ctx is None:
            return tensor
        scales, dtype, n, shape = ctx
        return self.decompress_flat(tensor, scales, dtype, n).reshape(shape)


# fp8 finite maxima: e4m3fn tops out at 448, e5m2 at 57344
_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


class Compression:
    """``Compression.none``, ``Compression.fp16`` (a bfloat16 wire, as in
    the JAX package), ``Compression.bf16``, ``Compression.float16`` (IEEE
    half), and the chunked formats ``fp8_e4m3`` (``fp8``), ``fp8_e5m2``
    and ``int8`` (symmetric per-chunk scale, round half to even)."""

    none = NoneCompressor()
    bf16 = _CastCompressor(torch.bfloat16, "bfloat16")
    fp16 = bf16
    float16 = _CastCompressor(torch.float16, "float16")
    fp8_e4m3 = ChunkedQuantizer(torch.float8_e4m3fn, _E4M3_MAX, "fp8_e4m3")
    fp8_e5m2 = ChunkedQuantizer(torch.float8_e5m2, _E5M2_MAX, "fp8_e5m2")
    fp8 = fp8_e4m3
    int8 = ChunkedQuantizer(torch.int8, 127.0, "int8", integer=True)


_BY_NAME = {
    "none": None,
    "bf16": Compression.bf16,
    "fp16": Compression.bf16,
    "float16": Compression.float16,
    "fp8": Compression.fp8_e4m3,
    "fp8_e4m3": Compression.fp8_e4m3,
    "fp8_e5m2": Compression.fp8_e5m2,
    "int8": Compression.int8,
}


def by_name(name):
    """Resolve a wire-dtype name to a compressor; ``"none"`` and None mean
    uncompressed. An unknown name raises ``ValueError``."""
    if name is None:
        return None
    try:
        return _BY_NAME[str(name).lower()]
    except KeyError:
        raise ValueError(
            f"unknown wire dtype {name!r}; pick one of "
            f"{sorted(_BY_NAME)}") from None


def resolve(compression):
    """``compression`` as a compressor object or None: a name goes
    through ``by_name``, ``Compression.none`` becomes None."""
    if isinstance(compression, str):
        compression = by_name(compression)
    if isinstance(compression, NoneCompressor):
        return None
    return compression
