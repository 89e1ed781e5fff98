"""Per-layer dependability policy maps — selective hardening as data.

A copy of ``repro.core.policy_map`` (pure Python), bound to the port's
``Policy``.  A :class:`PolicyMap` is an ordered rule list mapping *site
patterns* to a policy (and optionally an execution backend), with a
default for everything unmatched.

Sites are dotted names chosen by each integration point:

  shipdet conv layers       the ``ConvSpec.name`` of each layer (``stem``,
                            ``conv_24x3x3x24``, …, ``det_head``) — true
                            per-layer granularity (Python loop)
  engine state sites        ``weights`` / ``kv_cache`` / ``decode_state``
                            (:meth:`PolicyMap.scrub_mode` /
                            :meth:`PolicyMap.storage_policy`), for the
                            serving slice

Resolution precedence mirrors ``core.backend.resolve`` (per-call > per-layer
> global): an **exact** rule beats a **glob** rule (``fnmatch`` patterns, in
declaration order) beats the **default**; explicit per-call ``policy=``
arguments at the op layer always beat the map entirely.  Maps are frozen
and hashable, and round-trip through plain JSON (``to_doc``/``from_doc``)
in the same format as the reference's.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
import pathlib
from typing import Optional, Tuple, Union

from repro_torch.core.dependability import Policy

_GLOB_CHARS = frozenset("*?[")


def _is_glob(pattern: str) -> bool:
    return any(c in _GLOB_CHARS for c in pattern)


def _as_policy(p: Union[Policy, str]) -> Policy:
    return p if isinstance(p, Policy) else Policy(str(p).lower())


@dataclasses.dataclass(frozen=True)
class PolicyRule:
    """One ``pattern -> (policy, backend)`` assignment.  ``backend=None``
    inherits the map default (and ultimately the config/global backend)."""

    pattern: str
    policy: Policy
    backend: Optional[str] = None

    def to_doc(self) -> dict:
        doc = {"pattern": self.pattern, "policy": self.policy.value}
        if self.backend is not None:
            doc["backend"] = self.backend
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "PolicyRule":
        return cls(pattern=str(doc["pattern"]),
                   policy=_as_policy(doc["policy"]),
                   backend=doc.get("backend"))


@dataclasses.dataclass(frozen=True)
class PolicyMap:
    """Ordered site-pattern → policy assignment with a default."""

    rules: Tuple[PolicyRule, ...] = ()
    default: Policy = Policy.NONE
    default_backend: Optional[str] = None

    # -- resolution --------------------------------------------------------

    def resolve(self, site: str) -> Tuple[Policy, Optional[str]]:
        """(policy, backend) for ``site``: exact rule > glob rule (in
        declaration order) > default.  A rule without a backend inherits
        ``default_backend`` (which may itself be None → config/global)."""
        for r in self.rules:
            if not _is_glob(r.pattern) and r.pattern == site:
                return r.policy, r.backend or self.default_backend
        for r in self.rules:
            if _is_glob(r.pattern) and fnmatch.fnmatchcase(site, r.pattern):
                return r.policy, r.backend or self.default_backend
        return self.default, self.default_backend

    def policy_for(self, site: str) -> Policy:
        return self.resolve(site)[0]

    def backends(self) -> Tuple[str, ...]:
        """Every backend name the map can resolve to (for validation)."""
        names = {r.backend for r in self.rules if r.backend is not None}
        if self.default_backend is not None:
            names.add(self.default_backend)
        return tuple(sorted(names))

    # -- engine scrub derivation ------------------------------------------

    def scrub_mode(self) -> str:
        """Decode-state scrub mode implied by the transient-site policies
        (``kv_cache`` / ``decode_state``): the stronger ask wins — any CKPT
        ⇒ ``rollback`` (snapshot restore), any ABFT/DMR ⇒ ``detect``
        (alarm only), else ``off``."""
        pols = {self.policy_for("kv_cache"), self.policy_for("decode_state")}
        if Policy.CKPT in pols or Policy.TMR in pols:
            return "rollback"
        if Policy.ABFT in pols or Policy.DMR in pols:
            return "detect"
        return "off"

    def storage_policy(self) -> Policy:
        """Policy assigned to the persistent ``weights`` site — consumed by
        the engine's in-serve storage scrub (ABFT ⇒ detect every pump, CKPT
        ⇒ amortized verify + golden-parameter rollback)."""
        return self.policy_for("weights")

    # -- constructors ------------------------------------------------------

    @classmethod
    def uniform(cls, policy: Union[Policy, str],
                backend: Optional[str] = None) -> "PolicyMap":
        """The degenerate map: every site gets ``policy`` — semantically the
        legacy all-or-nothing configuration (and bit-identical to it; see
        tests/test_policy_map.py)."""
        return cls(rules=(), default=_as_policy(policy),
                   default_backend=backend)

    def is_uniform(self) -> Optional[Policy]:
        """The single policy every site resolves to, or None if mixed."""
        pols = {r.policy for r in self.rules} | {self.default}
        return self.default if len(pols) == 1 else None

    # -- serialization -----------------------------------------------------

    def to_doc(self) -> dict:
        doc = {"default": self.default.value,
               "rules": [r.to_doc() for r in self.rules]}
        if self.default_backend is not None:
            doc["default_backend"] = self.default_backend
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "PolicyMap":
        return cls(rules=tuple(PolicyRule.from_doc(r)
                               for r in doc.get("rules", ())),
                   default=_as_policy(doc.get("default", Policy.NONE)),
                   default_backend=doc.get("default_backend"))

    def dumps(self) -> str:
        return json.dumps(self.to_doc(), indent=2)

    @classmethod
    def loads(cls, text: str) -> "PolicyMap":
        return cls.from_doc(json.loads(text))

    def save(self, path) -> pathlib.Path:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.dumps() + "\n")
        return p

    @classmethod
    def load(cls, path) -> "PolicyMap":
        return cls.loads(pathlib.Path(path).read_text())

    def describe(self) -> str:
        """One-line human rendition, for logs and report tables."""
        parts = [f"{r.pattern}={r.policy.value}"
                 + (f"@{r.backend}" if r.backend else "")
                 for r in self.rules]
        parts.append(f"*={self.default.value}")
        return " ".join(parts)


def as_policy_map(value, *,
                  allow_none: bool = True) -> Optional[PolicyMap]:
    """Coerce user-facing inputs (PolicyMap | dict doc | JSON text | path to
    a JSON file | None) into a PolicyMap — the CLI/engine entry normalizer."""
    if value is None:
        if allow_none:
            return None
        raise ValueError("policy map required")
    if isinstance(value, PolicyMap):
        return value
    if isinstance(value, dict):
        return PolicyMap.from_doc(value)
    if isinstance(value, (str, pathlib.Path)):
        text = str(value)
        if text.lstrip().startswith("{"):
            return PolicyMap.loads(text)
        return PolicyMap.load(text)
    raise TypeError(f"cannot build a PolicyMap from {type(value).__name__}")
