"""Run the ``chip_smoke.py`` of another checkout of this repo with this
checkout's timers (``tools/timing.py``), so that the times of two commits,
taken in one call, come from one definition of a per-call and a
back-to-back time.

    python3 -m self_supervise_sfm_tpu_torch.tools.retime_tree OTHER [chip_smoke arguments]

OTHER is the root of the other checkout (a ``git archive`` of an earlier
commit, say). Its ``chip_smoke.py`` runs from OTHER with OTHER's package and
kernels, as ``cd OTHER && python3 chip_smoke.py`` would; only its
``_time_ms`` and ``_back_to_back_ms`` are replaced by this checkout's.
"""

from __future__ import annotations

import importlib.util
import os
import sys

from . import timing

PACKAGE = __package__.split(".")[0]


def main(argv: list) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(argv[0])
    # from here on the package is the other checkout's
    for name in [n for n in sys.modules if n == PACKAGE or n.startswith(PACKAGE + ".")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    os.chdir(root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke._time_ms = timing.per_call_ms
    smoke._back_to_back_ms = timing.back_to_back_ms
    sys.argv = [os.path.join(root, "chip_smoke.py"), *argv[1:]]
    return smoke.main()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
