"""Serve random prompts through the port's slot engine and print what it did.

    python -m repro_torch.launch.serve --arch qwen2-0.5b [--smoke] \
        --requests 8 --max-new 16 --slots 8 --max-len 1024 --sync-every 1 \
        [--device cpu]

Weights are random, made from ``--seed``. Runs on the card unless
``--device cpu`` is given. Prints ``served N/N``, syncs per decode step,
generated tokens per second (host clock, admission included) and the tier
bound to each API.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.profile import resolve_device
from repro_torch.models import transformer
from repro_torch.serving.engine import Request, ServingEngine


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--sync-every", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_config(args.arch + ("-smoke" if args.smoke else ""))
    params = transformer.init_model(cfg, seed=args.seed, device=dev)
    eng = ServingEngine(cfg, params, slots=args.slots, max_len=args.max_len,
                        sync_every=args.sync_every, seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    hi = min(args.max_len // 2, 500)
    for i in range(args.requests):
        plen = int(rng.integers(4, max(hi, 5)))
        eng.submit(Request(i, rng.integers(0, cfg.vocab_size, (plen,)),
                           args.max_new))
    t0 = time.perf_counter()
    results = eng.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    tokens = sum(len(r.tokens) for r in results.values())
    st = eng.stats
    print(f"served {len(results)}/{args.requests}  ({cfg.name} on {dev})")
    print(f"decode steps {st['decode_steps']}  syncs/step "
          f"{st['host_syncs_decode'] / max(st['decode_steps'], 1):.2f}  "
          f"prefill calls {st['prefill_calls']}")
    print(f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tok/s "
          "(host clock, admission included)")
    print("tiers: " + ", ".join(f"{k}={v}" for k, v in
                                sorted(eng.binding.providers().items())))
    return 0 if len(results) == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
