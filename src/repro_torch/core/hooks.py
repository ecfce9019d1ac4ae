"""Accelerated-API hook registry of the port (its own copy of the JAX
package's registry, so torch tiers never sit under the JAX API names).

Every model hot spot calls ``hooks.call("<api>", ...)``. Each API has a fixed
signature contract, a plain PyTorch reference (the ``torch-ref`` tier, always
correct, runs on any device) and zero or more system-optimized tiers
registered by provider tag (``cuda-sm90``: kernels written by hand for
Hopper). ``bind(profile)`` picks the first registered tier per API that the
profile supports; ``with hooks.use(binding):`` scopes it. Outside any such
scope ``call`` runs the reference on CPU tensors only and raises for tensors
on any other device, so a caller on the card always names its tier: the
plain one explicitly, with ``hooks.use(hooks.bind(None))``.

Probes: a tier may carry a probe that builds and runs a tiny candidate kernel
the way the tier would execute on the target. With ``bind(profile,
probe=True)`` a failed probe on a CPU profile rejects the tier (recorded in
the manifest) and dispatch falls to the next tier. On a profile whose
device is a GPU, a failed probe raises instead: a Hopper tier must never be
dropped to the plain tier quietly on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Mapping

__all__ = [
    "REFERENCE",
    "Binding",
    "HookError",
    "TierChoice",
    "bind",
    "call",
    "current_binding",
    "get_api",
    "list_apis",
    "register_api",
    "register_impl",
    "use",
]

REFERENCE = "torch-ref"  # provider tag of every API's reference tier


class HookError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class Implementation:
    provider: str
    fn: Callable[..., Any]
    supports: Callable[[Any], bool]  # predicate over a SystemProfile
    probe: Callable[[Any], Any] | None = None


@dataclasses.dataclass(frozen=True)
class TierChoice:
    """Why one provider serves one API in a binding (manifest line)."""

    api: str
    provider: str
    probed: bool
    rejected: tuple[tuple[str, str], ...] = ()  # (provider, error)

    def to_dict(self) -> dict:
        return {
            "provider": self.provider,
            "probed": self.probed,
            "rejected": [list(r) for r in self.rejected],
        }


@dataclasses.dataclass
class AcceleratedAPI:
    name: str
    signature: str
    reference: Callable[..., Any]
    impls: dict[str, Implementation] = dataclasses.field(default_factory=dict)


_REGISTRY: dict[str, AcceleratedAPI] = {}
_LOCK = threading.Lock()


class Binding(Mapping[str, Callable[..., Any]]):
    """Immutable api-name -> implementation mapping for one deployment."""

    def __init__(self, choices: dict[str, TierChoice], label: str):
        self.choices = dict(choices)
        self.label = label
        self._mapping = {
            name: (_REGISTRY[name].reference if c.provider == REFERENCE
                   else _REGISTRY[name].impls[c.provider].fn)
            for name, c in self.choices.items()}

    def __getitem__(self, k: str) -> Callable[..., Any]:
        return self._mapping[k]

    def __iter__(self):
        return iter(self._mapping)

    def __len__(self):
        return len(self._mapping)

    def providers(self) -> dict[str, str]:
        return {k: c.provider for k, c in self.choices.items()}

    def manifest(self) -> dict:
        """Serializable specialization manifest: chosen tier per API, with
        probe provenance and the tiers rejected on the way down."""
        return {"label": self.label,
                "apis": {k: self.choices[k].to_dict()
                         for k in sorted(self.choices)}}

    def __repr__(self):
        return f"Binding({self.label}: {self.providers()})"


class _State(threading.local):
    def __init__(self):
        self.stack: list[Binding] = []


_STATE = _State()


def register_api(name: str, signature: str,
                 reference: Callable[..., Any]) -> AcceleratedAPI:
    with _LOCK:
        if name in _REGISTRY:
            raise HookError(f"accelerated API {name!r} already registered")
        api = _REGISTRY[name] = AcceleratedAPI(name, signature, reference)
        return api


def register_impl(api_name: str, provider: str, fn: Callable[..., Any], *,
                  supports: Callable[[Any], bool] | None = None,
                  probe: Callable[[Any], Any] | None = None) -> None:
    if provider == REFERENCE:
        raise HookError(f"{REFERENCE!r} is the reference tier's own tag")
    with _LOCK:
        api = get_api(api_name)
        api.impls[provider] = Implementation(
            provider, fn, supports or (lambda profile: True), probe)


def get_api(name: str) -> AcceleratedAPI:
    api = _REGISTRY.get(name)
    if api is None:
        raise HookError(f"unknown accelerated API {name!r}")
    return api


def list_apis() -> list[str]:
    return sorted(_REGISTRY)


def _run_probe(impl: Implementation, profile: Any) -> str | None:
    """None when the probe passes, else the reason it failed."""
    try:
        out = impl.probe(profile)
    except Exception as e:  # noqa: BLE001 — any failure means "cannot bind"
        return f"{type(e).__name__}: {e}"
    return None if (out is None or out) else "probe returned falsy"


def bind(profile: Any = None, *, probe: bool = False) -> Binding:
    """First tier per API, in registration order, that ``profile`` supports
    (the reference everywhere when ``profile`` is None).

    With ``probe=True`` every candidate tier must pass its probe before it
    may bind; on a GPU profile (``profile.device != "cpu"``) a failed probe
    raises.
    """
    strict = getattr(profile, "device", "cpu") != "cpu"
    label = getattr(profile, "name", REFERENCE)
    choices: dict[str, TierChoice] = {}
    for name, api in _REGISTRY.items():
        best: Implementation | None = None
        rejected: list[tuple[str, str]] = []
        candidates = [] if profile is None else [
            i for i in api.impls.values() if i.supports(profile)]
        for impl in candidates:
            err = (_run_probe(impl, profile)
                   if probe and impl.probe is not None else None)
            if err is not None:
                if strict:
                    raise HookError(
                        f"tier {impl.provider!r} of API {name!r} failed its "
                        f"probe on {label}: {err}")
                rejected.append((impl.provider, err))
                continue
            best = impl
            break
        choices[name] = TierChoice(
            name, REFERENCE if best is None else best.provider,
            probed=probe and best is not None and best.probe is not None,
            rejected=tuple(rejected))
    return Binding(choices, label)


def current_binding() -> Binding | None:
    return _STATE.stack[-1] if _STATE.stack else None


@contextlib.contextmanager
def use(binding: Binding):
    _STATE.stack.append(binding)
    try:
        yield binding
    finally:
        _STATE.stack.pop()


def call(api_name: str, *args, **kwargs):
    """Invoke an API through the current binding. Outside any ``use()``
    scope the reference runs, and only on CPU tensors: a tensor on another
    device raises rather than take the plain path unseen."""
    binding = current_binding()
    if binding is not None and api_name in binding:
        return binding[api_name](*args, **kwargs)
    for a in (*args, *kwargs.values()):
        device = getattr(a, "device", None)
        if device is not None and getattr(device, "type", "cpu") != "cpu":
            raise HookError(
                f"{api_name!r} called on {device} with no binding in scope: "
                "wrap the call in hooks.use(ops.bind_for(device)), or in "
                "hooks.use(hooks.bind(None)) for the plain tier")
    return get_api(api_name).reference(*args, **kwargs)
