"""The port's dense model against the JAX package on the CPU in f32: the same
JAX-initialised weights go through ``repro_torch.models.bridge`` and the
same numpy inputs through both. Two configs: ``qwen2-0.5b-smoke``, and a
2-layer qwen2 that keeps the full head geometry (14/2 heads, head_dim 64,
d_model 896) with d_ff and vocab cut to 512."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import bridge  # noqa: E402
from repro_torch.models import ffn as tffn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

F32 = 2e-5  # tests/test_kernels.py::TOL[float32]


def two_layer_full_heads(mod):
    """qwen2-0.5b at 2 layers, full head geometry, d_ff/vocab 512, f32."""
    return dataclasses.replace(
        mod.get_config("qwen2-0.5b"), name="qwen2-0.5b-2l", num_layers=2,
        d_ff=512, vocab_size=512, param_dtype="float32",
        activ_dtype="float32")


CONFIGS = {
    "smoke": lambda mod: mod.get_config("qwen2-0.5b-smoke"),
    "2l-full-heads": two_layer_full_heads,
}


@pytest.fixture(scope="module", autouse=True)
def _cap_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    jcfg, tcfg = CONFIGS[request.param](jconfigs), CONFIGS[request.param](
        tconfigs)
    jparams = jtf.init_model(jax.random.key(0), jcfg)
    tparams = bridge.params_from_numpy(jax.device_get(jparams), tcfg,
                                       device="cpu")
    return jcfg, jparams, tcfg, tparams


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, scale=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    atol = F32 * (scale if scale is not None else max(1.0, np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=F32)


def _first_block(jparams, tparams):
    jblock = jax.tree.map(lambda a: a[0], jparams["scan"][0])
    return jblock, tparams["layers"][0]


def test_bridge_unstacks_layers(model):
    jcfg, jparams, tcfg, tparams = model
    assert len(tparams["layers"]) == tcfg.num_layers
    for i, layer in enumerate(tparams["layers"]):
        want = np.asarray(jparams["scan"][0]["mixer"]["wq"]["w"][i])
        np.testing.assert_array_equal(layer["mixer"]["wq"]["w"].numpy(), want)
    np.testing.assert_array_equal(tparams["embed"]["w"].numpy(),
                                  np.asarray(jparams["embed"]["w"]))


def test_norm_rope_swiglu(model):
    jcfg, jparams, tcfg, tparams = model
    jblock, tblock = _first_block(jparams, tparams)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    w = (rng.standard_normal(tcfg.d_model) * 0.1).astype(np.float32)
    _close(tlayers.norm({"w": _t(w)}, _t(x)),
           jlayers.norm({"w": jnp.asarray(w)}, jnp.asarray(x)))
    hd = tcfg.resolved_head_dim
    xr = rng.standard_normal((2, 5, 3, hd)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4], [7, 300, 901, 1023, 5]], np.int32)
    _close(tlayers.apply_rope(_t(xr), _t(pos), theta=tcfg.rope_theta),
           jlayers.apply_rope(jnp.asarray(xr), jnp.asarray(pos),
                              theta=jcfg.rope_theta))
    _close(tffn.apply(tblock["ffn"], tcfg, _t(x)),
           jffn.apply(jblock["ffn"], jcfg, jnp.asarray(x)))


def _chunk_inputs(cfg, rng, b=3, s=16, max_len=32):
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    lens = np.asarray([s, 5, 1][:b], np.int32)
    return x, lens, max_len


def test_attention_prefill_chunk_routes(model):
    """Fresh route (start=None, the flash kernel's API) and the chunk route
    (start tensor, chunk_attention) against JAX prefill_chunk at start 0:
    outputs at real positions and the cache below each row's length."""
    jcfg, jparams, tcfg, tparams = model
    jblock, tblock = _first_block(jparams, tparams)
    x, lens, max_len = _chunk_inputs(tcfg, np.random.default_rng(2))
    b, s = lens.shape[0], x.shape[1]
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jy, jst = jattn.prefill_chunk(
        jblock["mixer"], jcfg, jnp.asarray(x), jnp.asarray(pos),
        jattn.init_state(jcfg, b, max_len, jnp.float32),
        jnp.zeros((b,), jnp.int32), jnp.asarray(lens))
    starts = {"fresh": None, "chunk": torch.zeros(b, dtype=torch.int32)}
    for route, start in starts.items():
        st = tattn.init_state(tcfg, b, max_len, torch.float32, "cpu")
        ty, st = tattn.prefill_chunk(tblock["mixer"], tcfg, _t(x), _t(pos),
                                     st, start, _t(lens))
        for i, n in enumerate(lens):
            _close(ty[i, :n], np.asarray(jy)[i, :n])
            for kv in ("k", "v"):
                _close(st[kv][i, :n], np.asarray(jst[kv])[i, :n])
                assert not st[kv][i, n:].any(), (route, "pad written")


def test_attention_decode(model):
    jcfg, jparams, tcfg, tparams = model
    jblock, tblock = _first_block(jparams, tparams)
    rng = np.random.default_rng(3)
    b, max_len = 3, 32
    x = rng.standard_normal((b, tcfg.d_model)).astype(np.float32)
    shape = (b, max_len, tcfg.num_kv_heads, tcfg.resolved_head_dim)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    lens = np.asarray([1, 17, max_len], np.int32)
    jy, jst = jattn.decode(jblock["mixer"], jcfg, jnp.asarray(x),
                           {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                           jnp.asarray(lens))
    ty, tst = tattn.decode(tblock["mixer"], tcfg, _t(x),
                           {"k": _t(kc).clone(), "v": _t(vc).clone()},
                           _t(lens))
    _close(ty, jy)
    _close(tst["k"], jst["k"])
    _close(tst["v"], jst["v"])


def test_transformer_prefill_and_decode_logits(model):
    """Whole-model prefill_chunk (both routes) and decode_step logits, and
    the caches below each row's length."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(4)
    b, s, max_len = 3, 16, 32
    tokens = rng.integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)
    lens = np.asarray([s, 6, 1], np.int32)
    tokens[np.arange(s)[None, :] >= lens[:, None]] = 0
    jlog, jst, _ = jtf.prefill_chunk(
        jparams, jcfg, jnp.asarray(tokens),
        jtf.init_states(jcfg, b, max_len, jnp.float32),
        jnp.zeros((b,), jnp.int32), jnp.asarray(lens))
    jk = np.asarray(jst["scan"][0]["k"])  # (layers, B, max_len, Hkv, D)
    for start in (None, torch.zeros(b, dtype=torch.int32)):
        tst = ttf.init_states(tcfg, b, max_len, device="cpu")
        tlog, tst, _ = ttf.prefill_chunk(tparams, tcfg, _t(tokens), tst,
                                         start, _t(lens))
        assert tlog.dtype == torch.float32 and tlog.shape == (b, tcfg.vocab_size)
        _close(tlog, jlog)
        for layer, st in enumerate(tst):
            for i, n in enumerate(lens):
                _close(st["k"][i, :n], jk[layer, i, :n])
    # three decode steps from the prefilled state
    jlengths, tlengths = jnp.asarray(lens), _t(lens)
    cur = np.asarray(jnp.argmax(jlog, -1), np.int32)
    for _ in range(3):
        jlengths, tlengths = jlengths + 1, tlengths + 1
        jlog, jst = jtf.decode_step(jparams, jcfg, jnp.asarray(cur), jst,
                                    jlengths)
        tlog, tst = ttf.decode_step(tparams, tcfg, _t(cur), tst, tlengths)
        _close(tlog, jlog)
        cur = np.asarray(jnp.argmax(jlog, -1), np.int32)


def test_init_model_matches_jax_distributions():
    """Port-initialised weights follow the JAX package's init: truncated
    normals scaled by fan-in^-0.5 (embeddings at scale 1), zero biases and
    zero-centred norm weights; a seed fixes them."""
    cfg = two_layer_full_heads(tconfigs)
    p = ttf.init_model(cfg, seed=3, device="cpu")
    again = ttf.init_model(cfg, seed=3, device="cpu")
    assert torch.equal(p["layers"][1]["ffn"]["w_up"]["w"],
                       again["layers"][1]["ffn"]["w_up"]["w"])
    wq = p["layers"][0]["mixer"]["wq"]
    assert wq["w"].shape == (cfg.d_model, cfg.num_heads * 64)
    assert not wq["b"].any() and not p["final_norm"]["w"].any()
    # N(0,1) truncated at 2 sigma has std 0.8796
    assert abs(float(wq["w"].std()) * cfg.d_model**0.5 - 0.8796) < 0.01
    assert float(wq["w"].abs().max()) <= 2 * cfg.d_model**-0.5 + 1e-6
    assert abs(float(p["embed"]["w"].std()) - 0.8796) < 0.01
