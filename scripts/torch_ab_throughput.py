"""Env-steps/s of two or more checkouts of the repo on one card, in one call.

    python scripts/torch_ab_throughput.py ROOT [ROOT ...]

For each ROOT in the order given (for example parent, change, change,
parent), a fresh process imports that checkout's chip_smoke.py and runs
its device and build phases and its humanoid_bench and humanoid_terrain
throughput phases (f32, B=4096; chip_smoke.py phases 6 and 8), as that
checkout defines them.  Each output line is prefixed with the ROOT; the
exit code is the first non-zero one.  Comparing checkouts is only fair
within one call: the card's power limit and the host it shares differ
from call to call.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

RUN = """
import sys
sys.path.insert(0, {root!r})
import chip_smoke as c
card = c.phase_device()
c.phase_build()
c.phase_throughput(card)
c.phase_terrain_throughput(card)
"""


def main() -> int:
  roots = [pathlib.Path(r).resolve() for r in sys.argv[1:]]
  if not roots:
    print(__doc__)
    return 2
  rc = 0
  for root in roots:
    proc = subprocess.run([sys.executable, "-c", RUN.format(root=str(root))], cwd=root,
                          capture_output=True, text=True, timeout=900)
    for line in (proc.stdout + proc.stderr).splitlines():
      if line.startswith(("[device]", "[throughput]", "[terrain throughput]")) or proc.returncode:
        print(f"{root.name}: {line}", flush=True)
    print(f"{root.name}: exit {proc.returncode}", flush=True)
    rc = rc or proc.returncode
  return rc


if __name__ == "__main__":
  sys.exit(main())
