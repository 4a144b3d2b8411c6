"""Run one cell of the port's benchmark and print its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (the kernels built or loaded, the
inputs made from the seed, the port's model, one warm-up solve) counts in
``setup_s``, from the first line of this module; then the window runs
whole solves back to back for ``--seconds``; then the sampled answers are
judged against the plain reference. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last: each number compared with its limit. The same numbers
are the last lines of standard error.

Exits with 2 and prints no result when no CUDA card is available or the
cell asks for more cards than there are, and with 3 when a module of JAX
or of the JAX package is loaded once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi: not available"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi: no output"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from port_bench import harness

    chips = harness.load_cell(args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: {args.workload} needs {chips} CUDA card(s); {n} available",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", t_process=T_PROCESS)
    print(f"card: {_card_line()}", file=sys.stderr)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & harness.FORBIDDEN)
    if loaded:
        print(f"port_bench: modules loaded in this process that may not be: {loaded}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
