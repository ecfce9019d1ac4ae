"""The port stands alone and runs where it is told: it imports neither JAX
nor the JAX package, its entry points default to the card and raise when
there is none, and its hook registry binds the Hopper tiers only on a
Hopper profile, never dropping them quietly on a GPU."""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core import hooks  # noqa: E402
from repro_torch.core.profile import (H100_SM90, PORTABLE_CPU,  # noqa: E402
                                      resolve_device)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"
KERNEL_APIS = ("rmsnorm", "attention", "decode_attention")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print("IMPORTED", len([n for n in sys.modules if n.startswith("repro_torch")]))
print("BAD", bad)
"""


def test_importing_every_port_module_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC)), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert int(out.stdout.split("IMPORTED")[1].split()[0]) >= 15


def test_port_sources_name_no_jax_and_no_jax_package():
    pattern = re.compile(
        r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_)|from\s+(jax|jaxlib|repro)"
        r"(\.|\s))", re.MULTILINE)
    files = sorted(PORT.rglob("*.py")) + [SRC.parent / "chip_smoke.py"]
    assert len(files) > 15
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in pattern.finditer(f.read_text())]
    assert not hits, hits


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config("qwen2-0.5b-smoke")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_model(cfg)
    params = transformer.init_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--requests", "1"])
    assert resolve_device("cpu").type == "cpu"


def test_serve_cli_on_cpu(capsys):
    assert serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                       "--max-new", "4", "--slots", "2",
                       "--max-len", "64"]) == 0
    out = capsys.readouterr().out
    assert "served 3/3" in out and "syncs/step 1.00" in out
    assert "attention=torch-ref" in out


def test_binding_picks_tiers_by_profile():
    assert set(KERNEL_APIS) | {"matmul", "chunk_attention"} <= set(
        hooks.list_apis())
    hopper = hooks.bind(H100_SM90)
    for api in KERNEL_APIS:
        assert hopper.providers()[api] == ops.HOPPER
    assert hopper.providers()["matmul"] == hooks.REFERENCE
    cpu = hooks.bind(PORTABLE_CPU, probe=True)
    assert set(cpu.providers().values()) == {hooks.REFERENCE}
    assert all(not c["rejected"] for c in cpu.manifest()["apis"].values())
    assert hooks.bind(None).providers() == cpu.providers()
    assert ops.bind_for(torch.device("cpu")).providers() == cpu.providers()


def test_failed_probe_on_a_gpu_profile_raises():
    """Here the card is absent, so every Hopper probe fails: on the H100
    profile that must raise, not bind the plain tier."""
    with pytest.raises(hooks.HookError, match="probe"):
        hooks.bind(H100_SM90, probe=True)


def test_failed_probe_on_a_cpu_profile_is_recorded():
    profile = dataclasses.replace(PORTABLE_CPU, name="cpu-with-hopper-tag",
                                  capabilities=frozenset({ops.HOPPER}))
    b = hooks.bind(profile, probe=True)
    manifest = b.manifest()
    assert manifest["label"] == "cpu-with-hopper-tag"
    for api in KERNEL_APIS:
        assert b.providers()[api] == hooks.REFERENCE
        assert manifest["apis"][api]["rejected"][0][0] == ops.HOPPER


def test_call_without_a_binding_refuses_tensors_off_the_cpu():
    """Off the CPU (here the meta device stands in for the card) a call
    with no binding in scope raises instead of running the plain tier
    unseen; the plain tier runs there only when it is bound explicitly."""
    x, w = torch.ones(2, 8, device="meta"), torch.zeros(8, device="meta")
    q = torch.ones(2, 4, 16, device="meta")
    kc = torch.ones(2, 8, 2, 16, device="meta")
    lengths = torch.ones(2, dtype=torch.int32, device="meta")
    with pytest.raises(hooks.HookError, match="no binding"):
        hooks.call("rmsnorm", x, w)
    with pytest.raises(hooks.HookError, match="no binding"):
        hooks.call("decode_attention", torch.ones(2, 4, 16),
                   torch.ones(2, 8, 2, 16), torch.ones(2, 8, 2, 16),
                   lengths=lengths)
    with pytest.raises(hooks.HookError, match="no binding"):
        layers.norm({"w": w}, x)
    with hooks.use(hooks.bind(None)):
        assert hooks.call("rmsnorm", x, w).device.type == "meta"
        assert hooks.call("decode_attention", q, kc, kc,
                          lengths=lengths).shape == (2, 4, 16)
    assert hooks.call("rmsnorm", torch.ones(2, 8),
                      torch.zeros(8)).shape == (2, 8)


def test_call_dispatches_through_the_innermost_binding():
    x = torch.ones(2, 8)
    w = torch.zeros(8)
    seen = []
    pinned = hooks.bind(None)
    tracer = hooks.Binding(pinned.choices, "tracer")
    tracer._mapping["rmsnorm"] = lambda *a, **k: seen.append(1) or a[0]
    with hooks.use(pinned):
        with hooks.use(tracer):
            hooks.call("rmsnorm", x, w)
        hooks.call("rmsnorm", x, w)
    assert seen == [1]
    assert hooks.current_binding() is None
