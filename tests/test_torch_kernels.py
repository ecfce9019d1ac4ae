"""The port's kernel modules on the CPU: each kernel's plain PyTorch version
against the JAX package's reference (``repro.kernels.ref``) and its Pallas
kernel in interpret mode, on the same numpy inputs; the wrappers' CPU route;
and the wrappers' refusal of any non-CUDA device other than the CPU.

The CUDA kernels themselves run only on the card (``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import decode_attention as jdec  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import rmsnorm as jrms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py::TOL


@pytest.fixture(scope="module", autouse=True)
def _cap_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype, rows=None):
    got, want = _np(got), _np(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,d", [((2, 17), 64), ((3, 128), 256),
                                     ((1, 7), 100), ((8,), 896)])
def test_rmsnorm_plain_vs_jax(shape, d, dtype):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((*shape, d)).astype(np.float32)
    w = (rng.standard_normal(d) * 0.1).astype(np.float32)
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    got = trms.plain(tx, tw)
    assert got.dtype == tx.dtype
    _close(got, jref.rmsnorm(jx, jw), dtype)
    _close(got, jrms.rmsnorm(jx, jw, block_rows=8, interpret=True), dtype)


FLASH_CASES = [
    # b, sq, skv, hq, hkv, d, causal, window, softcap
    (1, 64, 64, 14, 2, 64, True, None, None),    # qwen2-0.5b heads, G = 7
    (2, 128, 128, 4, 2, 32, True, None, None),   # GQA
    (1, 64, 128, 4, 2, 32, True, None, None),    # Sq < Skv, suffix aligned
    (1, 128, 128, 2, 1, 32, True, 40, None),     # sliding window
    (1, 128, 128, 2, 2, 32, True, None, 30.0),   # logit softcap
    (1, 100, 100, 2, 1, 16, True, None, None),   # ragged, not a block multiple
    (1, 64, 64, 4, 4, 32, False, None, None),    # non-causal
    (1, 16, 8, 4, 2, 16, True, None, None),      # rows 0..7 see no key
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window,softcap",
                         FLASH_CASES)
def test_flash_plain_vs_jax(b, sq, skv, hq, hkv, d, causal, window, softcap,
                            dtype):
    rng = np.random.default_rng(sq * 131 + skv * 7 + hq)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    got = tfa.plain(tq, tk, tv, **kw)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    # the reference averages over every key in a row that sees none; the
    # kernels write zeros there
    seen = np.arange(sq) + (skv - sq) >= 0 if causal else np.ones(sq, bool)
    _close(got, jref.attention(jq, jk, jv, **kw), dtype, (slice(None), seen))
    assert not _np(got)[:, ~seen].any()
    # 8-row blocks: a block of unseeing rows is skipped whole by the Pallas
    # kernel, which then writes the same zeros
    _close(got, jfa.flash_attention(jq, jk, jv, block_q=8, block_k=8,
                                    interpret=True, **kw), dtype)


DECODE_CASES = [
    # b, s, hq, hkv, d, window, softcap, lengths
    (4, 64, 14, 2, 64, None, None, (1, 64, 37, 0)),  # G = 7, ragged, empty
    (2, 100, 4, 1, 32, None, None, (100, 33)),        # MQA, S not pow2
    (2, 128, 8, 2, 16, 24, None, (128, 50)),          # sliding window
    (2, 64, 4, 2, 32, None, 20.0, (64, 9)),           # logit softcap
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,hq,hkv,d,window,softcap,lengths", DECODE_CASES)
def test_decode_plain_vs_jax(b, s, hq, hkv, d, window, softcap, lengths,
                             dtype):
    rng = np.random.default_rng(s * 7 + hq)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    kw = dict(window=window, logit_softcap=softcap)
    got = tdec.plain(tq, tk, tv, lengths=torch.from_numpy(lens), **kw)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    seen = lens > 0
    _close(got, jref.decode_attention(jq, jk, jv, lengths=jnp.asarray(lens),
                                      **kw), dtype, seen)
    assert not _np(got)[~seen].any()
    # stale cache entries past a row's length never contribute
    tk2, tv2 = tk.clone(), tv.clone()
    for i, n in enumerate(lens):
        tk2[i, n:] = 1e4
        tv2[i, n:] = -1e4
    np.testing.assert_array_equal(
        _np(tdec.plain(tq, tk2, tv2, lengths=torch.from_numpy(lens), **kw)
            )[seen], _np(got)[seen])
    _close(got, jdec.decode_attention(jq, jk, jv, lengths=jnp.asarray(lens),
                                      block_k=32, interpret=True, **kw),
           dtype)


def test_wrappers_take_the_plain_route_on_cpu_without_counting():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((1, 9, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 9, 2, 16)).astype(np.float32))
    lens = torch.tensor([5], dtype=torch.int32)
    before = dict(build.LAUNCHES)
    assert torch.equal(trms.rmsnorm(x, w), trms.plain(x, w))
    assert torch.equal(tfa.flash_attention(q, k, k), tfa.plain(q, k, k))
    assert torch.equal(tdec.decode_attention(q[:, 0], k, k, lengths=lens),
                       tdec.plain(q[:, 0], k, k, lengths=lens))
    assert build.LAUNCHES == before


def test_wrappers_refuse_devices_they_have_no_kernel_for():
    """Only a CPU tensor takes the plain route; anything else goes to the
    kernel, which needs a CUDA tensor, or raises (no quiet fallback)."""
    x = torch.empty(2, 64, device="meta")
    q = torch.empty(1, 4, 2, 16, device="meta")
    with pytest.raises(build.KernelError):
        trms.rmsnorm(x, torch.empty(64, device="meta"))
    with pytest.raises(build.KernelError):
        tfa.flash_attention(q, q, q)
    with pytest.raises(build.KernelError):
        tdec.decode_attention(q[:, 0], q, q, lengths=torch.ones(
            1, dtype=torch.int32, device="meta"))
