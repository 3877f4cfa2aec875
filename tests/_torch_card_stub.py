"""A stand-in for the port's CUDA library, for tests on a machine with no
card: CPU tensors are sent down the card's route (`stub_card`) into a
`StubLibrary`, which records each C call of the attention kernels with the
inputs' addresses and the tensors the kernel would read there (through the
bias row stride it is given), and writes zeros to the outputs."""

import ctypes

import torch

import phenaki_tpu_torch.ops.flash_attention as fa
from phenaki_tpu_torch import _build


class StubLibrary:
    """Records each C call of the attention kernels; writes zeros."""

    def __init__(self, fail: bool = False):
        self.calls, self.fail = [], fail

    @staticmethod
    def _zero(ptr, n):
        ctypes.memset(ptr.value, 0, n)

    @staticmethod
    def _operands(q, k, v, bias, b, h, i, j, d, ldb, dtype, do=None):
        """Each input's address, and the tensor the kernel would read there:
        q, k, v (and the backward's dO) (b, h, n, d) contiguous; the bias
        h * i rows of j, ldb apart."""
        tdtype = next(t for t, code in _build.DTYPES.items() if code == dtype)
        size = torch.empty((), dtype=tdtype).element_size()

        def read(ptr, rows, cols, stride):
            raw = bytearray(ctypes.string_at(ptr.value, ((rows - 1) * stride + cols) * size))
            return torch.frombuffer(raw, dtype=tdtype).as_strided((rows, cols), (stride, 1)).clone()

        seen = {"q": q.value, "k": k.value, "v": v.value, "bias": bias.value}
        data = {"q": read(q, b * h * i, d, d).view(b, h, i, d),
                "k": read(k, b * h * j, d, d).view(b, h, j, d),
                "v": read(v, b * h * j, d, d).view(b, h, j, d)}
        if bias.value:
            data["bias"] = read(bias, h * i, j, ldb).view(h, i, j)
        if do is not None:
            seen["do"], data["do"] = do.value, read(do, b * h * i, d, d).view(b, h, i, d)
        return seen, data

    def flash_attention_fwd(self, q, k, v, bias, kmask, out, lse, b, h, i, j, d, ldb, scale, causal,
                            dtype, stream):
        seen, data = self._operands(q, k, v, bias, b, h, i, j, d, ldb, dtype)
        self.calls.append(("fwd", dict(seen, kmask=kmask.value, b=b, h=h, i=i, j=j, d=d, ldb=ldb,
                                       causal=causal, dtype=dtype, data=data)))
        self._zero(out, self._size(dtype) * b * h * i * d)
        if lse.value:
            self._zero(lse, 4 * b * h * i)
        return int(self.fail)

    def flash_attend_chunk_fwd(self, q, k, v, bias, kmask, c2, acc, l, b, h, i, j, d, ldb, scale,
                               causal, q_off, k_off, dtype, stream):
        seen, data = self._operands(q, k, v, bias, b, h, i, j, d, ldb, dtype)
        self.calls.append(("chunk", dict(seen, b=b, h=h, i=i, j=j, d=d, ldb=ldb, causal=causal,
                                         q_off=q_off, k_off=k_off, dtype=dtype, data=data)))
        self._zero(acc, 4 * b * h * i * d)
        self._zero(l, 4 * b * h * i)
        return int(self.fail)

    def _bwd(self, name, outputs, q, k, v, bias, do, b, h, i, j, d, ldb, causal, q_off, k_off, dtype):
        seen, data = self._operands(q, k, v, bias, b, h, i, j, d, ldb, dtype, do)
        self.calls.append((name, dict(seen, i=i, j=j, d=d, ldb=ldb, causal=causal, q_off=q_off,
                                      k_off=k_off, dtype=dtype, data=data)))
        for ptr, n in outputs:
            self._zero(ptr, n)
        return int(self.fail)

    @staticmethod
    def _size(dtype):
        return 2 if dtype == _build.DTYPES[torch.bfloat16] else 4

    def flash_attention_bwd_dq(self, q, k, v, bias, kmask, do, lse, delta, dq, b, h, i, j, d, ldb,
                               scale, causal, q_off, k_off, dtype, stream):
        return self._bwd("dq", [(dq, self._size(dtype) * b * h * i * d)], q, k, v, bias, do, b, h, i,
                         j, d, ldb, causal, q_off, k_off, dtype)

    def flash_attention_bwd_dkv(self, q, k, v, bias, kmask, do, lse, delta, dk, dv, b, h, i, j, d,
                                ldb, scale, causal, q_off, k_off, dtype, stream):
        n = self._size(dtype) * b * h * j * d
        return self._bwd("dkv", [(dk, n), (dv, n)], q, k, v, bias, do, b, h, i, j, d, ldb, causal,
                         q_off, k_off, dtype)

    def flash_attention_bwd_dbias(self, q, k, v, bias, kmask, do, lse, delta, dbias, b, h, i, j, d,
                                  ldb, scale, causal, q_off, k_off, dtype, stream):
        return self._bwd("dbias", [(dbias, 4 * h * i * j)], q, k, v, bias, do, b, h, i, j, d, ldb,
                         causal, q_off, k_off, dtype)


def stub_card(lib):
    """Send CPU tensors down the card's route, into `lib`; returns an undo."""
    saved = (fa._on_card, _build.load_library, _build.stream)
    fa._on_card = lambda *t: True
    _build.load_library = lambda: lib
    _build.stream = lambda device: ctypes.c_void_p(0)

    def undo():
        fa._on_card, _build.load_library, _build.stream = saved
    return undo
