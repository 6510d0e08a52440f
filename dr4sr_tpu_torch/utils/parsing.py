"""Safe parsing of run.py's final metric-dict line (a copy of
``dr4sr_tpu/utils/parsing.py``).

``run.py`` and ``python -m dr4sr_tpu_torch.run`` print the test metrics as a
python-dict repr on their last stdout line; the sweep/suite orchestrators (``scripts/run_suite.py``,
``scripts/regen_sweep.py``) parse it back. ``ast.literal_eval`` rejects the
``nan``/``inf`` tokens a diverged-but-completed run emits, and falling back to
``eval`` — even with empty ``__builtins__`` — is not a sandbox (attribute-chain
expressions still execute; ADVICE r2). This module substitutes the special
float tokens with sentinel strings, literal-evals, and restores them.
"""

from __future__ import annotations

import ast
import re
from typing import Any, Optional

# a bare nan/inf token: not part of a word and not quoted (so 'inf' the
# string value, or 'information' inside a key, is left alone)
_SPECIAL = re.compile(r"(?<![\w'\"])(-?)(nan|inf)(?![\w'\"])")

_SENTINELS = {
    "__nan__": float("nan"),
    "__-nan__": float("nan"),
    "__inf__": float("inf"),
    "__-inf__": float("-inf"),
}


def _restore(x: Any) -> Any:
    if isinstance(x, str) and x in _SENTINELS:
        return _SENTINELS[x]
    if isinstance(x, dict):
        return {k: _restore(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_restore(v) for v in x)
    return x


def parse_metric_line(line: str) -> Optional[dict]:
    """Parse one stdout line as a metrics dict; None if it isn't one.

    Handles plain reprs via ``ast.literal_eval`` and nan/inf-containing
    reprs via sentinel substitution — never ``eval``.
    """
    line = line.strip()
    if not (line.startswith("{") and line.endswith("}")):
        return None
    try:
        out = ast.literal_eval(line)
        return out if isinstance(out, dict) else None
    except (ValueError, SyntaxError):
        pass
    subbed = _SPECIAL.sub(lambda m: f"'__{m.group(1)}{m.group(2)}__'", line)
    try:
        out = ast.literal_eval(subbed)
    except (ValueError, SyntaxError):
        return None
    return _restore(out) if isinstance(out, dict) else None
