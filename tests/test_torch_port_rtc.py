"""The port's ``mx.rtc`` (NVRTC `CudaModule`) on the CPU: its signature
parser against the JAX package's, the launch contract of
``tests/test_rtc.py`` (errors, argument packing, in-place outputs) with
NVRTC and the CUDA driver replaced by a recording fake, the CPU paths that
must raise, and the JAX package's `PallasModule` results for its four RTC
test kernels against the plain versions of their CUDA counterparts
(`chip_smoke.RTC_CASES`, which the smoke and the card tests launch), and
the smoke's softmax tolerance, which must pass a sound kernel's output and
refuse planted faults.
"""
import ctypes
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import rtc as jrtc
from mxnet_tpu.base import MXNetError as JMXNetError
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd, rtc
from mxnet_tpu_torch.base import MXNetError
from chip_smoke import (RTC_CASES, rtc_close, rtc_planted_faults, rtc_scale,
                        softmax_bwd_plain, softmax_plain)

CPU = mx.cpu()

_VALID = ["const float *x, float *y, float alpha",
          "float* y", "const double *a,double *b", "__half *h, __half s",
          "bfloat16 *b, const int8_t *c, char k", "uint8_t *u, int64_t n",
          "int *i, int32_t j", "  const   float   *   x  "]
_INVALID = ["float* *bad name", "", "const float", "float *x y",
            "float &x", "unsigned int x", "float *x, "]


@pytest.mark.parametrize("sig", _VALID + _INVALID)
def test_signature_parser_matches_jax(sig):
    """Same grammar, names, dtypes, pointer and const flags, and the same
    errors; the port adds CUDA's ``__nv_bfloat16``."""
    try:
        want = [(n, str(d), p, c) for n, d, p, c in
                jrtc._parse_signature(sig)]
    except JMXNetError as e:
        with pytest.raises(MXNetError) as got:
            rtc._parse_signature(sig)
        assert str(got.value) == str(e)
        return
    got = [(n, str(d), p, c) for n, d, p, c in rtc._parse_signature(sig)]
    assert got == want


def test_signature_parser_takes_nv_bfloat16():
    (arg,) = rtc._parse_signature("const __nv_bfloat16 *x")
    assert arg == ("x", "bfloat16", True, True)
    with pytest.raises(JMXNetError, match="Unsupported"):
        jrtc._parse_signature("const __nv_bfloat16 *x")


class FakeDriver:
    """Records the NVRTC / driver calls `rtc` makes. A launch decodes its
    ``void**`` parameters while they are alive: each pointer parameter's
    8 bytes, each scalar's bytes (sized by the signature)."""

    def __init__(self):
        self.compiles, self.loads, self.smem, self.launches = [], [], [], []
        self.sizes = None

    def compile(self, source, options, exports):
        self.compiles.append((source, options, exports))
        return b"cubin", {e: "_Z%d%s" % (len(e), e) for e in exports}

    def load(self, index, image):
        self.loads.append((index, image))
        return ("module", len(self.loads))

    def function(self, index, module, symbol):
        return None if symbol == "missing" else ("fn", symbol)

    def set_max_dynamic_smem(self, index, fn, nbytes):
        self.smem.append((fn, nbytes))

    def launch(self, index, fn, grid, block, shared_mem, stream, params):
        raw = [ctypes.string_at(params[i], size)
               for i, size in enumerate(self.sizes)]
        self.launches.append(dict(fn=fn, grid=grid, block=block,
                                  shared_mem=shared_mem, stream=stream,
                                  raw=raw))


@pytest.fixture
def fake(monkeypatch):
    """`rtc` over `FakeDriver`, with every ``ctx`` standing for a card
    whose arrays live on the host and whose current stream is 0xBEEF."""
    drv = FakeDriver()
    monkeypatch.setattr(rtc, "_driver", lambda: drv)
    monkeypatch.setattr(rtc, "_cuda_device",
                        lambda ctx: mx.context.resolve_device(CPU))
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: mx.context.resolve_device(CPU).index)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(
                            cuda_stream=0xBEEF))
    return drv


def test_launch_contract_errors_before_any_driver_call(fake):
    """tests/test_rtc.py:67-97, in CUDA form: prototype, unknown kernel,
    exports gate, no output, argument count, dtype."""
    module = rtc.CudaModule('extern "C" __global__ void k(float *y) {}')
    with pytest.raises(MXNetError, match="prototype"):
        module.get_kernel("k", "float* *bad name")
    with pytest.raises(MXNetError, match="not defined"):
        module.get_kernel("missing", "float *y")
    f = module.get_kernel("k", "const float *y")
    with pytest.raises(MXNetError, match="no output"):
        f.launch([nd.zeros((2,), ctx=CPU)], CPU, (1,), (2,))
    f2 = module.get_kernel("k", "float *y")
    with pytest.raises(MXNetError, match="takes 1 arguments"):
        f2.launch([nd.zeros((2,), ctx=CPU), 1.0], CPU, (1,), (2,))
    with pytest.raises(MXNetError, match="dtype"):
        f2.launch([nd.zeros((2,), ctx=CPU, dtype="int32")], CPU, (1,), (2,))
    with pytest.raises(MXNetError, match="not contiguous"):
        f2.launch([nd.NDArray(torch.zeros(4)[::2])], CPU, (1,), (2,))
    for dims in ((), (1, 1, 1, 1), (0,)):
        with pytest.raises(MXNetError, match="grid_dims"):
            f2.launch([nd.zeros((2,), ctx=CPU)], CPU, dims, (2,))
    m = rtc.CudaModule("...", exports=["a"])
    with pytest.raises(MXNetError, match="not exported"):
        m.get_kernel("b", "float *y")
    assert fake.launches == [] and fake.smem == []
    assert [c[2] for c in fake.compiles] == [(), ("a",)]


def test_packed_launch(fake):
    """Pointers are ``data_ptr()``, scalars their C types' bytes, dims
    padded to 3, shared memory above 48 KB raises the function's limit
    once, the stream is the current torch stream's; non-const pointer
    arrays come back as the same objects, in signature order."""
    sig = ("const float *x, float *y, float a, double b, __half h, "
           "__nv_bfloat16 bf, int i, int8_t c, uint8_t u, int64_t n, "
           "int32_t *z")
    module = rtc.CudaModule("source", options=("-DX=1",),
                            exports=["kern<float>"])
    f = module.get_kernel("kern<float>", sig)
    x = nd.array(np.arange(4), ctx=CPU)
    y = nd.zeros((4,), ctx=CPU)
    z = nd.zeros((2, 3), ctx=CPU, dtype="int32")
    scalars = [1.5, 2.25, -0.5, 3.0, 7.9, -3, 200, 2 ** 40]
    fake.sizes = [8, 8, 4, 8, 2, 2, 4, 1, 1, 8, 8]
    before = rtc.CudaKernel.launches
    outs = f.launch([x, y] + scalars + [z], CPU, (3, 2), (64,),
                    shared_mem=100_000)
    f.launch([x, y] + scalars + [z], CPU, (3, 2), (64,), shared_mem=100_000)
    f.launch([x, y] + scalars + [z], CPU, (1,), (64,), shared_mem=1024)
    assert outs[0] is y and outs[1] is z and len(outs) == 2
    assert rtc.CudaKernel.launches == before + 3
    assert fake.compiles == [("source", ("-DX=1",), ("kern<float>",))]
    assert len(fake.loads) == 1
    assert fake.smem == [(("fn", "_Z11kern<float>"), 100_000)]
    first, last = fake.launches[0], fake.launches[-1]
    assert first["fn"] == ("fn", "_Z11kern<float>")
    assert (first["grid"], first["block"]) == ((3, 2, 1), (64, 1, 1))
    assert (first["shared_mem"], last["shared_mem"]) == (100_000, 1024)
    assert first["stream"] == 0xBEEF
    raw = first["raw"]
    ptr = [int.from_bytes(r, "little") for r in (raw[0], raw[1], raw[10])]
    assert ptr == [x._data.data_ptr(), y._data.data_ptr(),
                   z._data.data_ptr()]
    assert np.frombuffer(raw[2], np.float32)[0] == 1.5
    assert np.frombuffer(raw[3], np.float64)[0] == 2.25
    assert np.frombuffer(raw[4], np.float16)[0] == -0.5
    bf = torch.frombuffer(bytearray(raw[5]), dtype=torch.bfloat16)
    assert bf.item() == 3.0
    assert [np.frombuffer(r, d)[0] for r, d in
            ((raw[6], np.int32), (raw[7], np.int8), (raw[8], np.uint8),
             (raw[9], np.int64))] == [7, -3, 200, 2 ** 40]


def test_non_ndarray_pointer_args_raise(fake):
    """A pointer parameter takes an NDArray and nothing else: a numpy array
    or a list raises before any driver call."""
    f = rtc.CudaModule("s").get_kernel("k", "const float *x, float *y")
    y = nd.zeros((3,), ctx=CPU)
    for bad in (np.arange(3, dtype=np.float32), [0.0, 0.0, 0.0]):
        with pytest.raises(MXNetError, match="arg 'x' is a pointer and "
                                             "takes an NDArray"):
            f.launch([bad, y], CPU, (1,), (3,))
    with pytest.raises(MXNetError, match="arg 'y' is a pointer"):
        f.launch([y, np.zeros(3, np.float32)], CPU, (1,), (3,))
    assert fake.launches == []


def test_no_cpu_path():
    """A CPU ctx raises, and without a card so does compiling."""
    with pytest.raises(MXNetError, match="no CPU path"):
        rtc._cuda_device(CPU)
    with pytest.raises(MXNetError, match="no CPU path"):
        rtc._cuda_device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="needs a CUDA card"):
            rtc.CudaModule(RTC_CASES["axpy"]["source"])
        with pytest.raises(MXNetError, match="device='cpu'"):
            rtc._cuda_device(mx.gpu(0))


# the JAX tests' Pallas kernels and launch geometry (tests/test_rtc.py)
_PALLAS = {
    "axpy": ("def axpy(x_ref, y_ref, alpha_ref):\n"
             "    y_ref[...] += alpha_ref[0] * x_ref[...]\n",
             (1, 1, 1), (10, 1, 1)),
    "scale": ("def scale(a_ref, out_ref, s_ref):\n"
              "    out_ref[...] = a_ref[...] * s_ref[0]\n", (4,), (2,)),
    "inc": ("def inc(y_ref):\n    y_ref[...] += 1.0\n", (1,), None),
    "addk": ("def addk(x_ref, y_ref, k_ref):\n"
             "    y_ref[...] = x_ref[...] + k_ref[0]\n", (1,), None),
}


@pytest.mark.parametrize("name", sorted(RTC_CASES))
def test_pallas_kernels_match_plain_cuda_counterparts(name):
    """`mxnet_tpu.rtc.PallasModule` (interpret mode on the CPU) and the
    plain version of the CUDA kernel the card tests launch give the same
    output on the same inputs."""
    case = RTC_CASES[name]
    source, grid, block = _PALLAS[name]
    func = jrtc.PallasModule(source).get_kernel(name, case["signature"])
    args = [jmx.nd.array(v, dtype=v.dtype) if isinstance(v, np.ndarray)
            else v for v in case["inputs"]()]
    for _ in range(case["launches"]):
        outs = func.launch(args, jmx.cpu(0), grid, block)
    want = case["plain"](*[torch.from_numpy(v) if isinstance(v, np.ndarray)
                           else v for v in case["inputs"]()])
    np.testing.assert_array_equal(outs[0].asnumpy(), want.numpy())
    assert str(outs[0].dtype) == str(want.numpy().dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_tolerance_passes_sound_output_and_refuses_faults(dtype):
    """`chip_smoke.rtc_close`, the smoke's and the card tests' check of the
    softmax kernels, on BERT-width rows (30,522 columns): torch's own
    softmax and softmax backward (f32 math, rounded once to ``dtype``)
    pass against the plain versions; outputs zeroed below 1e-6, or rounded
    coarser than their type, fail."""
    tdt = getattr(torch, dtype)
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(4, 30522) * 3).to(tdt)
    dy = torch.from_numpy(rng.randn(4, 30522)).to(tdt)
    y = torch.softmax(x.float(), -1).to(tdt)
    dx = torch._softmax_backward_data(dy.float(), y.float(), -1,
                                      torch.float32).to(tdt)
    for which, got, want in (("fwd", y, softmax_plain(torch, x)),
                             ("bwd", dx, softmax_bwd_plain(y, dy))):
        scale = rtc_scale(which, want, y, dy)
        rtc_close(torch, got, want, scale, dtype, which)
        rtc_planted_faults(torch, got, want, scale, dtype, which)
        assert float((got.float().abs() < 1e-6).float().mean()) > 0.3
