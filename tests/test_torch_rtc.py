"""The port's runtime-compiled CUDA kernels (``tpu_mx_torch/rtc.py``).

A CUDA C kernel compiles and runs only on the card: there
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` launch the kernels
below and hold them to ``x * 3`` and ``a * b + a``.  Here, on the CPU:
the module API (kernels, exports, the reference's not-found error), the
parameter lists read from the source, static binding and its errors,
that ``launch`` on host tensors raises instead of pretending, and the
reference's own rtc kernels (``tests/test_rtc_quant.py``) on the same
inputs, which fix the function the card tests hold the port to.
"""
import ctypes

import numpy as np
import pytest
import torch

import tpu_mx as mx
from tpu_mx import nd

from tpu_mx_torch import rtc
from tpu_mx_torch.base import MXNetError

SOURCE = r'''
// y = x * alpha (the reference's scale_kernel)
extern "C" __global__ void scale(const float* __restrict__ x,
                                 float* __restrict__ y, float alpha, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * alpha;
}

/* o = a * b + a (the reference's addmul) */
extern "C" __global__ void __launch_bounds__(256)
addmul(const float* a, const float* b, float* o, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) o[i] = a[i] * b[i] + a[i];
}
'''


def test_module_lists_its_kernels_and_honours_exports():
    mod = rtc.CudaModule(SOURCE)
    assert mod.kernels == ["addmul", "scale"]
    only = rtc.CudaModule(SOURCE, exports=["scale"])
    only.get_kernel("scale", alpha=1.0)
    with pytest.raises(MXNetError, match="not found/exported"):
        only.get_kernel("addmul")
    with pytest.raises(MXNetError, match="not found/exported"):
        mod.get_kernel("nope")
    # the reference's error for the same call
    from tpu_mx.base import MXNetError as RefError
    with pytest.raises(RefError, match="not found/exported"):
        mx.rtc.PallasModule({}, exports=[]).get_kernel("nope")
    with pytest.raises(MXNetError, match="not found/exported"):
        rtc.CudaModule("", exports=[]).get_kernel("nope")


def test_parameter_lists_are_read_from_the_source():
    mod = rtc.CudaModule(SOURCE)
    f, i32, i64 = ctypes.c_float, ctypes.c_int32, ctypes.c_int64
    assert mod.get_kernel("scale", alpha=3.0).params == [
        ("x", "pointer", None), ("y", "pointer", None),
        ("alpha", "scalar", f), ("n", "scalar", i32)]
    assert mod.get_kernel("addmul").params == [
        ("a", "pointer", None), ("b", "pointer", None),
        ("o", "pointer", None), ("n", "scalar", i64)]
    every = rtc.CudaModule(r'''
    // extern "C" __global__ void commented_out(char c) {}
    extern "C" __global__ void every(const double *in, int *out,
        float a, double b, int c, unsigned d, unsigned int e, long long g,
        int64_t h, const bool k, uint32_t m) {}
    extern "C" __global__ void none() {}
    ''')
    assert every.kernels == ["every", "none"]
    k = every.get_kernel("every", a=1.5, b=2.5, c=-3, d=4, e=5, g=2 ** 40,
                         h=-7, k=True, m=9)
    assert [(p, t) for p, _, t in k.params[2:]] == [
        ("a", f), ("b", ctypes.c_double), ("c", i32),
        ("d", ctypes.c_uint32), ("e", ctypes.c_uint32), ("g", i64),
        ("h", i64), ("k", ctypes.c_bool), ("m", ctypes.c_uint32)]
    assert every.get_kernel("none").params == []


def test_a_type_it_cannot_pass_raises_at_get_kernel():
    mod = rtc.CudaModule(r'''
    extern "C" __global__ void pair(const float* x, float* y, float2 v) {}
    extern "C" __global__ void byref(const float* x, float& y) {}
    ''')
    for name in ("pair", "byref"):
        with pytest.raises(MXNetError, match="cannot pass"):
            mod.get_kernel(name)


def test_static_binding_and_its_errors():
    mod = rtc.CudaModule(SOURCE)
    with pytest.raises(MXNetError, match=r"\['alpha'\] are not bound"):
        mod.get_kernel("scale")
    with pytest.raises(MXNetError, match="no scalar parameter"):
        mod.get_kernel("scale", alpha=3.0, beta=1.0)
    with pytest.raises(MXNetError, match="no scalar parameter"):
        mod.get_kernel("scale", alpha=3.0, x=1)      # x is a pointer
    with pytest.raises(MXNetError, match="not a c_float"):
        mod.get_kernel("scale", alpha="three")
    with pytest.raises(MXNetError, match="does not fit"):
        mod.get_kernel("scale", alpha=3.0, n=2 ** 31)
    # n may be bound explicitly; it is then not the output's size
    assert mod.get_kernel("scale", alpha=3.0, n=5)._static["n"].value == 5


def test_launch_on_host_tensors_raises_without_compiling():
    mod = rtc.CudaModule(SOURCE)
    k = mod.get_kernel("scale", alpha=3.0)
    before = rtc.Kernel.launches
    with pytest.raises(MXNetError, match="no CUDA-C interpreter"):
        k.launch((torch.ones(8),))
    with pytest.raises(MXNetError, match="no CUDA-C interpreter"):
        k(torch.ones(8))                              # __call__ = launch
    with pytest.raises(MXNetError, match="torch tensors"):
        k.launch((np.ones(8, np.float32),))
    with pytest.raises(MXNetError, match="torch tensors"):
        k.launch(())
    assert rtc.Kernel.launches == before
    assert mod._key is None            # nvcc never ran: built at launch


def test_reference_rtc_kernels_compute_what_the_card_is_held_to():
    """The reference's PallasModule kernels (interpret mode) on the
    inputs the card tests use: ``scale`` with ``alpha=3.0`` is ``x *
    3.0`` bit for bit, and ``addmul`` is ``a * b + a``."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 256).astype(np.float32)
    a, b = (rng.randn(4, 256).astype(np.float32) for _ in range(2))

    def scale_kernel(x_ref, o_ref, *, alpha):
        o_ref[:] = x_ref[:] * alpha

    def addmul(a_ref, b_ref, o_ref):
        o_ref[:] = a_ref[:] * b_ref[:] + a_ref[:]

    y = mx.rtc.PallasModule({"scale": scale_kernel}).get_kernel(
        "scale", alpha=3.0).launch((nd.array(x),), out_shape=x.shape)
    np.testing.assert_array_equal(y.asnumpy(), x * np.float32(3.0))
    o = mx.rtc.PallasModule(addmul).get_kernel("addmul")(
        (nd.array(a), nd.array(b)))
    # XLA may fuse a * b + a into one FMA, as nvcc may: the two roundings
    # differ by an ulp of the terms, not of a result that cancels
    err = np.abs(o.asnumpy() - (a * b + a))
    assert np.all(err <= 1e-6 * (np.abs(a * b) + np.abs(a)))
