"""Process-level service protocol constants — a LEAF module.

A copy of ``shapley_vit_tpu/driver/protocol.py``: the port imports nothing
of the JAX package, so it keeps its own copy, and its supervisor and status
tools read the port's constants. The values are the JAX package's, so an
output directory reads the same under either package's tools.

The recycle supervisor (driver/supervisor.py) is a thin Popen+wait parent
whose whole point is bounding the service's RSS; importing these from
driver/serve.py would transitively pull torch and the model stack into that
parent. Anything shared
between the supervisor and the service lives here instead, import-free
beyond the stdlib. driver/serve.py re-exports these names, so library
users keep the one import surface.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

#: ``svt-serve`` exit code when the service stopped because RSS crossed
#: ``max_rss_mb``. The supervisor restarts on exactly this code; anything
#: else is a clean stop (0) or a crash.
RECYCLE_EXIT_CODE = 3

STATE_FILENAME = "service_state.json"

#: Touching ``<out_dir>/DRAIN`` asks a running service to stop after its
#: in-flight round (manual operator control; SIGTERM writes it too so every
#: rank of a multi-host fleet sees the request through the shared dir).
DRAIN_FILENAME = "DRAIN"


def read_service_state(out_dir: str) -> Optional[Dict]:
    """The last persisted service state, or None (no file / unreadable —
    an interrupted very first round restarts from the configured epoch)."""
    try:
        with open(os.path.join(out_dir, STATE_FILENAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
