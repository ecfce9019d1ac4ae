#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
last line:

1. device: the card's name, power limit and capability, which must be (9, 0);
2. build: the hand-written kernels, compiled from ``src/repro_torch/csrc``
   for sm_90a, and their register and shared-memory use;
3. kernels: each kernel against its plain PyTorch version on the card, in
   bf16 and f32, at the serving path's shapes and at edge cases;
4. serving: full-width qwen2-0.5b (24 layers, bf16, random weights from a
   seeded ``torch.Generator``) serves 16 greedy requests through
   ``repro_torch.serving.engine.ServingEngine`` (8 slots, max_len 1024,
   buckets 32/128/512); every kernel must have been launched by that run;
5. consistency: the same requests through the plain tier on the card; the
   streams must match except after a near-tie of the plain path's logits;
6. times: each kernel at the path's shapes beside its bound, its plain
   version and one PyTorch library call computing the same function
   (device time per call, from CUDA-graph replay);
7. profile: host wall against device busy time of full decode steps.

The line before the card line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SEED = 0
SLOTS, MAX_LEN, BUCKETS = 8, 1024, (32, 128, 512)
MAX_NEW = 32
NEAR_TIE = 2e-2  # of max |logit|: a gap the two tiers may order differently
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
REPLACES = {  # the Pallas TPU kernel each one replaces (pl.pallas_call line)
    "rmsnorm": "src/repro/kernels/rmsnorm.py:50",
    "flash_attention": "src/repro/kernels/flash_attention.py:156",
    "decode_attention": "src/repro/kernels/decode_attention.py:130",
}
SOURCES = {k: f"src/repro_torch/csrc/{k}.cu" for k in REPLACES}


def say(*a) -> None:
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, the graph replayed between two CUDA events. The replay
    issues no Python, so this is the device's time, not the host's time to
    launch. Inputs stay in L2 between calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class Smoke:
    def __init__(self, dev):
        from repro_torch import configs
        from repro_torch.core import hooks
        from repro_torch.core.profile import H100_SM90
        from repro_torch.kernels import build, ops
        from repro_torch.kernels import decode_attention as dec
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import rmsnorm as rms
        from repro_torch.models import transformer
        from repro_torch.serving import engine
        self.configs, self.hooks, self.profile = configs, hooks, H100_SM90
        self.build, self.ops, self.tf, self.engine = build, ops, transformer, engine
        self.kmod = {"rmsnorm": rms, "flash_attention": fa,
                     "decode_attention": dec}
        self.dev = dev
        self.gen = torch.Generator(device=dev).manual_seed(SEED)
        self.record = {k: {"name": k, "route": "cuda", "source": SOURCES[k],
                           "replaces": REPLACES[k]} for k in REPLACES}

    def randn(self, *shape, dtype=torch.float32, scale=1.0):
        t = torch.randn(*shape, generator=self.gen, device=self.dev) * scale
        return t.to(dtype)

    # -- phase 2 -------------------------------------------------------
    def build_kernels(self):
        t0 = time.perf_counter()
        self.build.library()
        say(f"[build] {len(self.build.sources())} sources, nvcc in parallel,"
            f" {time.perf_counter() - t0:.1f} s "
            f"(cached={self.build.build_info['cached']})")
        for line in self.build.build_info["log"].splitlines():
            if line.startswith("==") or "Used" in line:
                say("[build] " + line.strip())

    # -- phase 3 -------------------------------------------------------
    def compare(self, name, got, want, dtype, what) -> float:
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = err <= TOL[dtype] * max(1.0, want.float().abs().max().item())
        say(f"[kernels] {name} {what} {str(dtype)[6:]}: max|err| {err:.3g} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name} {what}: {err} beyond tolerance")
        return err

    def rms_inputs(self, rows, dtype):
        return (self.randn(rows, 896, dtype=dtype),
                self.randn(896, dtype=dtype, scale=0.1))

    def flash_inputs(self, b, sq, skv, hq, hkv, d, dtype):
        return (self.randn(b, sq, hq, d, dtype=dtype),
                self.randn(b, skv, hkv, d, dtype=dtype),
                self.randn(b, skv, hkv, d, dtype=dtype))

    def decode_inputs(self, lengths, s, hq, hkv, d, dtype):
        b = len(lengths)
        return (self.randn(b, hq, d, dtype=dtype),
                self.randn(b, s, hkv, d, dtype=dtype),
                self.randn(b, s, hkv, d, dtype=dtype),
                torch.tensor(lengths, dtype=torch.int32, device=self.dev))

    def kernels_vs_plain(self):
        rms, fa, dec = (self.kmod[k] for k in REPLACES)
        errs = {k: 0.0 for k in REPLACES}
        for dtype in (torch.bfloat16, torch.float32):
            for rows in (8, 4 * 512, 7):  # decode, prefill, ragged
                x, w = self.rms_inputs(rows, dtype)
                e = self.compare("rmsnorm", rms.rmsnorm(x, w), rms.plain(x, w),
                                 dtype, f"rows={rows} D=896")
                if dtype == torch.bfloat16:
                    errs["rmsnorm"] = max(errs["rmsnorm"], e)
            for case in [
                # b, sq, skv, hq, hkv, d, causal, window, softcap
                (4, 512, 512, 14, 2, 64, True, None, None),  # slice, G = 7
                (8, 32, 32, 14, 2, 64, True, None, None),
                (1, 64, 128, 4, 2, 32, True, None, None),    # Sq < Skv
                (1, 128, 128, 2, 1, 32, True, 40, None),     # window
                (1, 128, 128, 2, 2, 128, True, None, 30.0),  # softcap
                (1, 100, 100, 2, 1, 16, True, None, None),   # ragged tail
                (1, 64, 64, 4, 4, 32, False, None, None),    # non-causal
                (1, 16, 8, 4, 2, 16, True, None, None),      # unseeing rows
            ]:
                b, sq, skv, hq, hkv, d, causal, window, cap = case
                q, k, v = self.flash_inputs(b, sq, skv, hq, hkv, d, dtype)
                kw = dict(causal=causal, window=window, logit_softcap=cap)
                e = self.compare("flash_attention",
                                 fa.flash_attention(q, k, v, **kw),
                                 fa.plain(q, k, v, **kw), dtype, str(case))
                if dtype == torch.bfloat16 and case[3] == 14:
                    errs["flash_attention"] = max(errs["flash_attention"], e)
            for lengths, s, hq, hkv, d, window, cap in [
                ((1, 1024, 300, 77, 512, 1000, 33, 640), 1024, 14, 2, 64,
                 None, None),                                # slice, G = 7
                ((0, 1, 64, 17), 64, 14, 2, 64, None, None),  # empty row
                ((100, 33), 100, 4, 1, 32, None, None),       # MQA
                ((128, 50), 128, 8, 2, 16, 24, None),         # window
                ((64, 9), 64, 4, 2, 128, None, 20.0),         # softcap
            ]:
                q, kc, vc, lens = self.decode_inputs(lengths, s, hq, hkv, d,
                                                     dtype)
                kw = dict(lengths=lens, window=window, logit_softcap=cap)
                e = self.compare(
                    "decode_attention", dec.decode_attention(q, kc, vc, **kw),
                    dec.plain(q, kc, vc, **kw), dtype,
                    f"lengths={lengths} S={s} Hq={hq} Hkv={hkv} D={d} "
                    f"window={window} softcap={cap}")
                if dtype == torch.bfloat16 and hq == 14:
                    errs["decode_attention"] = max(errs["decode_attention"], e)
        for k, e in errs.items():
            self.record[k]["max_abs_err"] = e

    # -- phase 4 / 5 ---------------------------------------------------
    def requests(self, cfg):
        rng = np.random.default_rng(SEED)
        spans = [(20, 32)] * 6 + [(33, 128)] * 5 + [(129, 500)] * 5
        return [self.engine.Request(
                    i, rng.integers(0, cfg.vocab_size, int(rng.integers(*s) + 1)),
                    MAX_NEW) for i, s in enumerate(spans)]

    def serve(self, cfg, params, binding, reqs):
        eng = self.engine.ServingEngine(
            cfg, params, slots=SLOTS, max_len=MAX_LEN, prompt_buckets=BUCKETS,
            binding=binding, seed=SEED, device=self.dev)
        for r in reqs:
            eng.submit(r)
        t0 = time.perf_counter()
        results = eng.run_to_completion()
        torch.cuda.synchronize()
        return eng, results, time.perf_counter() - t0

    def serving(self):
        cfg = self.configs.get_config("qwen2-0.5b")
        params = self.tf.init_model(cfg, seed=SEED, device=self.dev)
        n_params = sum(t.numel() for t in _leaves(params))
        say(f"[serving] {cfg.name}: {cfg.num_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
            f"{n_params / 1e6:.1f} M params in {cfg.param_dtype}")
        binding = self.ops.bind_for(self.dev)
        manifest = binding.manifest()
        say("[serving] manifest " + json.dumps(manifest, sort_keys=True))
        for api in ("rmsnorm", "attention", "decode_attention"):
            tier = manifest["apis"][api]
            if tier["provider"] != self.ops.HOPPER or tier["rejected"]:
                raise AssertionError(f"{api} bound to {tier}")
        reqs = self.requests(cfg)
        # warm-up: first cuBLAS calls and allocator growth, outside the run
        self.serve(cfg, params, binding, reqs[:2])
        shapes, prefill = [], self.tf.prefill_chunk

        def recording_prefill(params, cfg, tokens, *rest):
            shapes.append(tuple(tokens.shape))  # host-side, no device read
            return prefill(params, cfg, tokens, *rest)

        self.tf.prefill_chunk = recording_prefill
        try:
            self.build.reset_launches()
            eng, results, wall = self.serve(cfg, params, binding, reqs)
            launches = dict(self.build.LAUNCHES)
        finally:
            self.tf.prefill_chunk = prefill
        say(f"[serving] prefill groups (batch, bucket): {shapes}")
        self.prefill_shape = max(shapes, key=lambda bs: bs[0] * bs[1])
        st = eng.stats
        say(f"[serving] served {len(results)}/{len(reqs)}")
        if len(results) != len(reqs) or st["unserved"]:
            raise AssertionError("not every request was served")
        tokens = sum(len(r.tokens) for r in results.values())
        lat = eng.latency_summary()
        say(f"[serving] decode steps {st['decode_steps']}, prefill calls "
            f"{st['prefill_calls']}, syncs/step "
            f"{st['host_syncs_decode'] / st['decode_steps']:.2f}")
        say(f"[serving] {tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} "
            f"tok/s (host clock, admission included); TTFT p50 "
            f"{lat['ttft_p50_s'] * 1e3:.1f} ms p95 "
            f"{lat['ttft_p95_s'] * 1e3:.1f} ms; decode step "
            f"{st['step_wall_s'] / st['decode_steps'] * 1e3:.2f} ms")
        for r in reqs:
            got = results[r.request_id].tokens
            if len(got) != MAX_NEW or not all(0 <= t < cfg.vocab_size
                                              for t in got):
                raise AssertionError(f"request {r.request_id}: {got}")
        n_layers, steps, calls = cfg.num_layers, st["decode_steps"], \
            st["prefill_calls"]
        want = {"rmsnorm": (2 * n_layers + 1) * (steps + calls),
                "flash_attention": n_layers * calls,
                "decode_attention": n_layers * steps}
        say(f"[serving] launches {launches} (expected {want})")
        if launches != want:
            raise AssertionError("the path did not run through every kernel "
                                 "as often as expected")
        for k, n in launches.items():
            self.record[k]["launches"] = n
        self.main = (cfg, params, reqs, results, eng)
        self.binding = binding

    def consistency(self):
        cfg, params, reqs, results, eng = self.main
        plain = self.hooks.bind(None)
        _, plain_results, wall = self.serve(cfg, params, plain, reqs)
        say(f"[consistency] plain tier served {len(plain_results)} requests "
            f"in {wall:.3f} s")
        divergent = 0
        for r in reqs:
            a = results[r.request_id].tokens
            b = plain_results[r.request_id].tokens
            t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
            if t is None:
                continue
            divergent += 1
            logits = self.plain_logits(cfg, params, plain, r.prompt, b[:t])
            gap = (logits[b[t]] - logits[a[t]]).item()
            scale = logits.abs().max().item()
            say(f"[consistency] request {r.request_id} diverges at token {t}:"
                f" plain {b[t]} vs kernel {a[t]}, plain logit gap {gap:.4g} "
                f"of max {scale:.4g}")
            if gap >= NEAR_TIE * scale:
                raise AssertionError(
                    f"request {r.request_id}: divergence at token {t} is not "
                    "a near-tie")
        say(f"[consistency] {len(reqs) - divergent}/{len(reqs)} streams "
            f"identical; {divergent} diverge after a near-tie")

    def plain_logits(self, cfg, params, binding, prompt, stream):
        """Logits of the plain tier for the token after ``stream``."""
        prompt = torch.as_tensor(np.asarray(prompt, np.int32), device=self.dev)
        n = prompt.shape[0]
        with self.hooks.use(binding):
            states = self.tf.init_states(cfg, 1, MAX_LEN, device=self.dev)
            lengths = torch.tensor([n], dtype=torch.int32, device=self.dev)
            logits, states, _ = self.tf.prefill_chunk(
                params, cfg, prompt[None], states, None, lengths)
            for tok in stream:
                lengths = lengths + 1
                logits, states = self.tf.decode_step(
                    params, cfg, torch.tensor([tok], dtype=torch.int32,
                                              device=self.dev),
                    states, lengths)
        torch.cuda.synchronize()
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits on the plain tier")
        return logits[0]

    # -- phase 6 -------------------------------------------------------
    def times(self):
        rms, fa, dec = (self.kmod[k] for k in REPLACES)
        p = self.profile
        bf16 = torch.bfloat16
        cfg, _, reqs, _, _ = self.main
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

        def put(name, shape, kernel, plain, library, nbytes, flops, peak):
            t_bytes = nbytes / p.hbm_bytes_per_s * 1e3
            t_ops = flops / peak * 1e3
            rec = self.record[name]
            rec.update(ms=time_ms(kernel), plain_ms=time_ms(plain),
                       library_ms=time_ms(library),
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            say(f"[times] {name} {shape}: device ms per call: kernel "
                f"{rec['ms']:.5f}, plain {rec['plain_ms']:.5f}, library "
                f"{rec['library_ms']:.5f}, bound {rec['bound_ms']:.6f} "
                f"({rec['bound_by']}: {nbytes / 1e6:.3f} MB, "
                f"{flops / 1e9:.4f} GFLOP)")

        # rmsnorm: the decode step's shape (47 of every 49 launches)
        x, w = self.rms_inputs(SLOTS, bf16)
        w1 = 1.0 + w
        put("rmsnorm", f"x ({SLOTS}, {cfg.d_model}) bf16",
            lambda: rms.rmsnorm(x, w), lambda: rms.plain(x, w),
            lambda: F.rms_norm(x, (cfg.d_model,), w1, 1e-6),
            2 * x.numel() * 2 + w.numel() * 2, 4 * x.numel(), p.f32_flops)
        # flash: the main run's largest admission group
        b, s = self.prefill_shape
        q, k, v = self.flash_inputs(b, s, s, hq, hkv, d, bf16)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = b * hq * s * (s + 1) // 2
        put("flash_attention", f"q ({b}, {s}, {hq}, {d}) k/v ({b}, {s}, {hkv}, "
            f"{d}) bf16 causal",
            lambda: fa.flash_attention(q, k, v),
            lambda: fa.plain(q, k, v),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            (q.numel() * 2 + k.numel() + v.numel()) * 2, 4 * d * pairs,
            p.bf16_flops)
        # decode: the first wave's slots midway through their 32 tokens
        lengths = [len(r.prompt) + MAX_NEW // 2 for r in reqs[:SLOTS]]
        q, kc, vc, lens = self.decode_inputs(lengths, MAX_LEN, hq, hkv, d, bf16)
        mask = (torch.arange(MAX_LEN, device=self.dev)[None, :]
                < lens[:, None])[:, None, None, :]
        kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
        seen = sum(lengths)
        put("decode_attention", f"q ({SLOTS}, {hq}, {d}) cache ({SLOTS}, "
            f"{MAX_LEN}, {hkv}, {d}) bf16 lengths {lengths}",
            lambda: dec.decode_attention(q, kc, vc, lengths=lens),
            lambda: dec.plain(q, kc, vc, lengths=lens),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True),
            2 * seen * hkv * d * 2 + 2 * q.numel() * 2 + SLOTS * 4,
            4 * hq * d * seen, p.bf16_flops)


    def step_profile(self, steps: int = 8):
        """Host wall and device busy time of full decode steps (8 active
        slots), the device time from torch.profiler's kernel events."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        cfg, params, reqs, _, _ = self.main
        eng = self.engine.ServingEngine(
            cfg, params, slots=SLOTS, max_len=MAX_LEN, prompt_buckets=BUCKETS,
            binding=self.binding, seed=SEED, device=self.dev)
        for r in reqs[:SLOTS]:
            eng.submit(self.engine.Request(100 + r.request_id, r.prompt,
                                           4 * steps))
        eng.step()  # admission and the first step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
        per_name: dict[str, float] = {}
        count = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per_name[e.name] = per_name.get(e.name, 0.0) \
                    + e.time_range.elapsed_us() / 1e3 / steps
                count += 1
        busy = sum(per_name.values())
        if busy == 0.0:
            say("[profile] the trace holds no device time: device busy share "
                "not measured")
            return
        say(f"[profile] decode step at {SLOTS} active slots: host wall "
            f"{wall:.3f} ms; device busy {busy:.3f} ms in {count / steps:.0f} "
            f"kernels; device busy share {busy / wall:.4f} of the unprofiled "
            f"wall")
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
        for name, ms in top:
            say(f"[profile]   {ms:.4f} ms/step  {name[:110]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = smi_line()
    cap = torch.cuda.get_device_capability(dev)
    say(f"[device] {card}; capability {cap}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    if cap != (9, 0):
        print(f"chip_smoke: capability {cap}, need (9, 0)", file=sys.stderr)
        return 1
    smoke = Smoke(dev)
    for name, phase in [("build", smoke.build_kernels),
                        ("kernels", smoke.kernels_vs_plain),
                        ("serving", smoke.serving),
                        ("consistency", smoke.consistency),
                        ("times", smoke.times),
                        ("profile", smoke.step_profile)]:
        t0 = time.perf_counter()
        try:
            phase()
        except Exception:  # noqa: BLE001 — report the phase, then fail
            traceback.print_exc()
            print(f"chip_smoke: phase {name} failed", file=sys.stderr)
            return 1
        say(f"[{name}] phase ok in {time.perf_counter() - t0:.1f} s")
    say(json.dumps({"kernels": list(smoke.record.values())}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
