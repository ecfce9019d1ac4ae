"""The port's slot engine against the JAX package's ``ServingEngine`` on the
CPU, in f32, on the cases ``tests/test_serving.py`` uses: greedy streams
must be identical, and every logits row the port's engine computes (prefill
and each decode step, in its real batched context) must agree with the JAX
model's logits at the same position of the same stream.

Smoke greedy streams often repeat one token, so the logits check is what
has teeth."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import hooks  # noqa: E402
from repro_torch.core.profile import PORTABLE_CPU  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.models import bridge  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving.sampling import (SamplingConfig,  # noqa: E402
                                          SamplingParams, sample_batched)

F32 = 2e-5  # tests/test_kernels.py::TOL[float32], relative to logit scale
MAX_LEN = 128
ENGINE = dict(slots=4, max_len=MAX_LEN, prompt_buckets=(16, 32))


def two_layer_full_heads(mod):
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
    jcfg, tcfg = CONFIGS[request.param](jconfigs), CONFIGS[request.param](
        tconfigs)
    jparams = jtf.init_model(jax.random.key(0), jcfg)
    tparams = bridge.params_from_numpy(jax.device_get(jparams), tcfg,
                                       device="cpu")
    return jcfg, jparams, tcfg, tparams


# ---------------------------------------------------------------------------
# the cases of tests/test_serving.py, as (engine options, requests)
# ---------------------------------------------------------------------------
def _more_requests_than_slots(vocab):
    rng = np.random.default_rng(0)
    return {}, [(i, rng.integers(0, vocab, int(rng.integers(4, 16))),
                 int(rng.integers(2, 8)), None) for i in range(10)]


def _max_new_tokens_one(vocab):
    return {}, [(0, np.arange(8), 1, None), (1, np.arange(8), 3, None),
                (2, np.arange(4), 1, None), (3, np.arange(6) + 9, 4, None)]


def _overlong_prompt(vocab):
    # 100 tokens land in the max_len bucket; 128 fill the cache (one token)
    return {}, [(0, np.arange(100) % vocab, 4, None),
                (1, (np.arange(128) * 3) % vocab, 4, None)]


def _sync_every_4(vocab):
    rng = np.random.default_rng(1)
    return {"sync_every": 4}, [
        (i, rng.integers(0, vocab, int(rng.integers(4, 30))),
         int(rng.integers(2, 12)), None) for i in range(6)]


CASES = {
    "more_requests_than_slots": _more_requests_than_slots,
    "max_new_tokens_one": _max_new_tokens_one,
    "overlong_prompt": _overlong_prompt,
    "sync_every_4": _sync_every_4,
}


def _run_jax(jcfg, jparams, opts, reqs):
    eng = jengine.ServingEngine(jcfg, jparams, **ENGINE, **opts)
    for rid, prompt, max_new, eos in reqs:
        eng.submit(jengine.Request(rid, np.asarray(prompt, np.int32),
                                   max_new, eos_id=eos))
    return {rid: r.tokens for rid, r in eng.run_to_completion().items()}


def _run_port(tcfg, tparams, opts, reqs, monkeypatch, binding=None):
    """Serve ``reqs`` on the port's engine and record every logits row it
    computes: prefill rows with their prompts, decode rows with the slot
    table and lengths of that step."""
    eng = tengine.ServingEngine(tcfg, tparams, device="cpu", binding=binding,
                                **ENGINE, **opts)
    log = {"prefill": [], "decode": []}
    real_prefill, real_decode = ttf.prefill_chunk, ttf.decode_step

    def prefill(params, cfg, tokens, states, start, lengths):
        out = real_prefill(params, cfg, tokens, states, start, lengths)
        log["prefill"].append((tokens.numpy().copy(), lengths.numpy().copy(),
                               out[0].numpy().copy()))
        return out

    def decode(params, cfg, tokens, states, lengths):
        out = real_decode(params, cfg, tokens, states, lengths)
        log["decode"].append((
            [None if r is None else r.request_id for r in eng.active],
            lengths.numpy().copy(), out[0].numpy().copy()))
        return out

    monkeypatch.setattr(ttf, "prefill_chunk", prefill)
    monkeypatch.setattr(ttf, "decode_step", decode)
    for rid, prompt, max_new, eos in reqs:
        eng.submit(tengine.Request(rid, prompt, max_new, eos_id=eos))
    results = eng.run_to_completion()
    monkeypatch.undo()
    return eng, {rid: r.tokens for rid, r in results.items()}, log


@functools.lru_cache(maxsize=None)
def _jax_programs(jcfg):
    prefill = jax.jit(lambda p, t, s, st, ln: jtf.prefill_chunk(
        p, jcfg, t, s, st, ln))
    decode = jax.jit(lambda p, t, s, ln: jtf.decode_step(p, jcfg, t, s, ln))
    return prefill, decode


def _jax_logits(jcfg, jparams, prompts, streams):
    """The JAX model's logits along each stream: [prefill, after token 0,
    after token 1, ...], all rows teacher-forced together."""
    prefill, decode = _jax_programs(jcfg)
    n = len(prompts)
    tokens = np.zeros((n, MAX_LEN), np.int32)
    lens = np.asarray([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    logits, states, _ = prefill(
        jparams, jnp.asarray(tokens),
        jtf.init_states(jcfg, n, MAX_LEN, jnp.float32),
        jnp.zeros((n,), jnp.int32), jnp.asarray(lens))
    per = [[np.asarray(logits[i])] for i in range(n)]
    lengths = lens.copy()
    for t in range(max(len(s) for s in streams) - 1):
        live = np.asarray([t < len(s) - 1 for s in streams])
        tok = np.asarray([s[t] if t < len(s) else 0 for s in streams],
                         np.int32)
        lengths = lengths + live
        logits, states = decode(jparams, jnp.asarray(tok), states,
                                jnp.asarray(lengths))
        for i in np.nonzero(live)[0]:
            per[i].append(np.asarray(logits[i]))
    return per


def _check_logits(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= F32 * scale, f"{what}: max |diff| {err} > {F32} * {scale}"


def _check_against_jax(model, case, monkeypatch, binding=None):
    jcfg, jparams, tcfg, tparams = model
    opts, reqs = CASES[case](tcfg.vocab_size)
    want = _run_jax(jcfg, jparams, opts, reqs)
    eng, got, log = _run_port(tcfg, tparams, opts, reqs, monkeypatch, binding)
    assert got == want
    assert eng.stats["retired"] == len(reqs) and eng.stats["unserved"] == 0

    ids = [rid for rid, *_ in reqs]
    prompts = {rid: np.asarray(p, np.int32) for rid, p, *_ in reqs}
    ref = dict(zip(ids, _jax_logits(jcfg, jparams, [prompts[i] for i in ids],
                                    [want[i] for i in ids])))
    checked = 0
    for tokens, lens, logits in log["prefill"]:
        for row in range(tokens.shape[0]):
            prompt = tokens[row, :lens[row]]
            for rid in ids:
                if np.array_equal(prompts[rid], prompt):
                    _check_logits(logits[row], ref[rid][0], f"prefill {rid}")
                    checked += 1
    for slot_ids, lengths, logits in log["decode"]:
        for slot, rid in enumerate(slot_ids):
            if rid is None or lengths[slot] == 0:
                continue
            t = int(lengths[slot]) - 1 - len(prompts[rid])
            _check_logits(logits[slot], ref[rid][t + 1],
                          f"request {rid} decode step {t}")
            checked += 1
    # every emitted token's logits row was compared
    assert checked >= sum(len(s) for s in want.values())
    return eng, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_engine_matches_jax_engine(model, case, monkeypatch):
    _check_against_jax(model, case, monkeypatch)


def test_eos_stops_generation_like_jax(model, monkeypatch):
    jcfg, jparams, tcfg, tparams = model
    prompt = np.arange(6, dtype=np.int32)
    first = _run_jax(jcfg, jparams, {}, [(0, prompt, 50, None)])[0][1]
    CASES["_eos"] = lambda vocab: ({}, [(1, prompt, 50, int(first)),
                                        (2, prompt + 1, 5, None)])
    try:
        _, want = _check_against_jax(model, "_eos", monkeypatch)
    finally:
        del CASES["_eos"]
    assert want[1][-1] == first and len(want[1]) < 50


def test_kernel_tier_wrappers_serve_on_cpu(model, monkeypatch):
    """The cuda-sm90 tier bound on a CPU profile that carries its tag: each
    wrapper takes its plain route, streams and logits still match JAX, and
    no launch is counted."""
    profile = dataclasses.replace(PORTABLE_CPU, name="cpu-with-hopper-tag",
                                  capabilities=frozenset({ops.HOPPER}))
    binding = hooks.bind(profile)
    assert all(binding.providers()[api] == ops.HOPPER
               for api in ("rmsnorm", "attention", "decode_attention"))
    before = dict(build.LAUNCHES)
    eng, _ = _check_against_jax(model, "more_requests_than_slots",
                                monkeypatch, binding)
    assert eng.binding.providers()["attention"] == ops.HOPPER
    assert build.LAUNCHES == before


def test_engine_counts_one_sync_per_step_and_admission_retirement():
    cfg = tconfigs.get_config("qwen2-0.5b-smoke")
    params = ttf.init_model(cfg, seed=0, device="cpu")
    eng = tengine.ServingEngine(cfg, params, device="cpu", slots=2,
                                max_len=64, prompt_buckets=(8, 16))
    for i in range(2):  # retire straight from the prefill logits
        eng.submit(tengine.Request(i, np.arange(4), 1))
    for i in range(2, 4):
        eng.submit(tengine.Request(i, np.arange(6) + i, 4))
    eng.step()
    assert sorted(eng.results) == [0, 1]
    assert sum(r is not None for r in eng.active) == 2
    res = eng.run_to_completion()
    assert [len(res[i].tokens) for i in range(4)] == [1, 1, 4, 4]
    assert eng.stats["host_syncs_decode"] == eng.stats["decode_steps"] == 3
    with pytest.raises(ValueError):
        eng.submit(tengine.Request(3, np.arange(4), 2))  # duplicate id
    with pytest.raises(ValueError):
        eng.submit(tengine.Request(9, np.arange(65), 2))  # > max_len


def test_engine_refuses_what_is_not_ported():
    cfg = tconfigs.get_config("qwen2-0.5b-smoke")
    params = ttf.init_model(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError):
        tengine.ServingEngine(cfg, params, device="cpu", page_size=16)
    with pytest.raises(NotImplementedError):
        tengine.ServingEngine(cfg, params, device="cpu",
                              prefix_cache_bytes=1 << 20)
    with pytest.raises(TypeError):
        tengine.ServingEngine(cfg, params, device="cpu", no_such_option=1)


def test_sampling_greedy_exact_and_topk_bounded():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 50)).astype(np.float32)
    cfgs = [SamplingConfig(), SamplingConfig(0.8, 3), SamplingConfig(1.0, 1),
            SamplingConfig(1.5, 0)]
    params = SamplingParams.from_configs(cfgs, "cpu")
    t = torch.from_numpy(logits)
    greedy = sample_batched(t, params, None)
    assert greedy.dtype == torch.int32
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))
    gen = torch.Generator().manual_seed(0)
    top3 = set(np.argsort(-logits[1])[:3])
    for _ in range(20):
        ids = sample_batched(t, params, gen).numpy()
        assert ids[0] == logits[0].argmax() and ids[2] == logits[2].argmax()
        assert ids[1] in top3 and 0 <= ids[3] < 50
