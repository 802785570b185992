"""Deprecation plumbing for the legacy ``schedule_*`` free functions.

Under the ``"default"`` warning ACTION a DeprecationWarning shows once per
(module, lineno) — i.e. exactly once per CALL SITE — which is the behaviour
the shims' tests pin down.  Note that plain ``python script.py`` ignores
DeprecationWarning outside ``__main__`` entirely (PEP 565); the warnings are
visible under ``-W default``, pytest's filters, or from __main__ code.
``stacklevel=3`` attributes the warning to the shim's caller:
helper (1) -> shim (2) -> call site (3).
"""
from __future__ import annotations

import warnings


def warn_deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"{old} is deprecated; use {new} (see docs/API.md migration table)",
        DeprecationWarning,
        stacklevel=3,
    )
