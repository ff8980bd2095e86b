"""Gradient wire compression of the classic torch adapter: the port of
``horovod_tpu/torch/compression.py`` (Horovod's
``horovod/torch/compression.py``): a cast to fp16 before the collective
and back after."""


class NoneCompressor:
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP16Compressor:
    @staticmethod
    def compress(tensor):
        if tensor.dtype.is_floating_point:
            return tensor.half(), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class Compression:
    """The namespace of ``hvd.Compression.none`` and ``.fp16``."""
    none = NoneCompressor
    fp16 = FP16Compressor
