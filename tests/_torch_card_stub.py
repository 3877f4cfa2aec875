"""A stand-in for the port's CUDA library, for tests on a machine with no
card: CPU tensors are sent down the card's route (`stub_card`) into a
`StubLibrary`, which records each C call of the attention kernels with the
inputs' addresses and the tensors the kernel would read there (through the
bias row stride it is given), and writes zeros to the outputs; a call of
PEG's stencil is recorded with x's address and strides, and gets the plain
version's result written through the output's strides; so is a call of the
norm kernels (`ops.norms.layer_norm`, `ops.attention.qk_norm_split`), with the
addresses and strides the wrapper passes, and of the GEGLU GEMM
(`ops.feedforward.geglu_gemm`), whose h and packed pre-activation get the plain
version's values."""

import ctypes

import numpy as np
import torch

import phenaki_tpu_torch.ops.flash_attention as fa
from phenaki_tpu_torch import _build
from phenaki_tpu_torch.ops import norms
from phenaki_tpu_torch.ops.attention import qk_norm_split_plain
from phenaki_tpu_torch.ops.feedforward import geglu_packed
from phenaki_tpu_torch.ops.positional import peg_stencil_plain


class StubLibrary:
    """Records each C call of the attention kernels (writes zeros) and of
    PEG's stencil (writes the plain version's result)."""

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

    @staticmethod
    def _view(ptr, shape, strides, dtype):
        """A tensor over the memory at `ptr` (no copy) with these strides."""
        span = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
        ctype = ctypes.c_float if dtype == torch.float32 else ctypes.c_uint16
        flat = torch.from_numpy(np.ctypeslib.as_array(ctypes.cast(ptr.value, ctypes.POINTER(ctype)), (span,)))
        return (flat if dtype == torch.float32 else flat.view(dtype)).as_strided(shape, strides)

    def peg_stencil(self, x, weight, bias, out, b, t, h, w, d, xs0, xs1, xs2, xs3, os0, os1, os2, os3,
                    causal, dtype, weight_dtype, stream):
        tdtype = next(k for k, v in _build.DTYPES.items() if v == dtype)
        wdtype = next(k for k, v in _build.DTYPES.items() if v == weight_dtype)
        shape = (b, t, h, w, d)
        xv = self._view(x, shape, (xs0, xs1, xs2, xs3, 1), tdtype)
        wv = self._view(weight, (d, 1, 3, 3, 3), (27, 27, 9, 3, 1), wdtype)
        bv = self._view(bias, (d,), (1,), wdtype)
        self.calls.append(("peg", dict(x=x.value, strides=(xs0, xs1, xs2, xs3), out_strides=(os0, os1, os2, os3),
                                       causal=causal, dtype=dtype, weight_dtype=weight_dtype)))
        self._view(out, shape, (os0, os1, os2, os3, 1), tdtype).copy_(peg_stencil_plain(xv, wv, bv, bool(causal)))
        return int(self.fail)

    @staticmethod
    def _norm_dtype(code):
        return next(k for k, v in norms.DTYPES.items() if v == code)

    def layer_norm_fwd(self, x, gamma, beta, out, rows, d, x_stride, out_stride, eps, dtype, param_dtype,
                       stream):
        tdtype, pdtype = self._norm_dtype(dtype), self._norm_dtype(param_dtype)
        xv = self._view(x, (rows, d), (x_stride, 1), tdtype)
        gv = self._view(gamma, (d,), (1,), pdtype)
        bv = self._view(beta, (d,), (1,), pdtype) if beta.value else None
        self.calls.append(("layer_norm", dict(x=x.value, rows=rows, d=d, x_stride=x_stride, out_stride=out_stride,
                                              beta=bool(beta.value), eps=eps, dtype=dtype, param_dtype=param_dtype)))
        self._view(out, (rows, d), (out_stride, 1), tdtype).copy_(norms.layer_norm_plain(xv, gv, bv))
        return int(self.fail)

    def qk_norm_split(self, q, k, v, null_k, null_v, q_scale, k_scale, q_out, k_out, v_out, b, n, m, num_null,
                      h, d, qs0, qs1, ks0, ks1, vs0, vs1, ns0, ns1, dtype, scale_dtype, stream):
        tdtype, sdtype = self._norm_dtype(dtype), self._norm_dtype(scale_dtype)
        qv = self._view(q, (b, n, h * d), (qs0, qs1, 1), tdtype)
        kv = [self._view(t, (b, m, h * d), (s0, s1, 1), tdtype) for t, s0, s1 in ((k, ks0, ks1), (v, vs0, vs1))]
        null_kv = None
        if num_null:
            null_kv = torch.cat([self._view(t, (h, num_null, d), (ns0, ns1, 1), tdtype) for t in (null_k, null_v)],
                                dim=1)
        scales = [self._view(t, (d,), (1,), sdtype) for t in (q_scale, k_scale)]
        self.calls.append(("qk_norm_split", dict(q=q.value, k=k.value, v=v.value, null_k=null_k.value or 0,
                                                 null_v=null_v.value or 0, b=b, n=n, m=m, num_null=num_null, h=h, d=d,
                                                 strides=((qs0, qs1), (ks0, ks1), (vs0, vs1)), null_strides=(ns0, ns1),
                                                 dtype=dtype, scale_dtype=scale_dtype)))
        outs = qk_norm_split_plain(qv, *kv, h, *scales, null_kv)
        for ptr, t in zip((q_out, k_out, v_out), outs):
            self._view(ptr, tuple(t.shape), torch.empty(t.shape).stride(), tdtype).copy_(t)
        return int(self.fail)

    def geglu_gemm(self, x, w, h, pre, rows, d, ip, splits, dtype, stream):
        tdtype = next(k for k, v in _build.DTYPES.items() if v == dtype)
        xv = self._view(x, (rows, d), (d, 1), tdtype)
        wv = self._view(w, (2 * ip, d), (d, 1), tdtype)
        self.calls.append(("geglu_gemm", dict(x=x.value, w=w.value, rows=rows, d=d, ip=ip, splits=splits,
                                              dtype=dtype, pre=bool(pre.value))))
        p = torch.matmul(xv, wv.t())
        self._view(h, (rows, ip), (ip, 1), tdtype).copy_(geglu_packed(p))
        if pre.value:
            self._view(pre, (rows, 2 * ip), (2 * ip, 1), tdtype).copy_(p)
        return int(self.fail)


def stub_card(lib):
    """Send CPU tensors down the card's route, into `lib`; returns an undo."""
    saved = (fa._on_card, _build.load_library, _build.stream)
    fa._on_card = lambda *t: True
    _build.load_library = lambda: lib
    _build.stream = lambda device: ctypes.c_void_p(0)

    def undo():
        fa._on_card, _build.load_library, _build.stream = saved
    return undo
