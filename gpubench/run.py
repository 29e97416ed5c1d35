"""Run one cell once:

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result's JSON object; the numbers the comparison read, each beside its
limit, are the last lines of standard error and the result's last key.
Exits with another code than 0 and prints no result when the card is
missing, when the program cannot be loaded, or when JAX or the JAX
package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gpubench import harness

    try:
        result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                             T_START)
    except harness.NoChip as e:
        print(f"gpubench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"gpubench: modules loaded in this process: {', '.join(found)}; the run may "
              "load neither JAX nor the JAX package", file=sys.stderr)
        return 3
    from gpubench.device import device_label

    try:
        print(f"gpubench: {device_label()}", file=sys.stderr)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"gpubench: nvidia-smi gave no label ({e})", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
