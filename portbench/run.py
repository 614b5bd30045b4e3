"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout of the repository, on a machine with as many
CUDA cards as the cell asks for.  With ``--trace 0`` the line's metrics are
the cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics,
read from one more solve under the profiler and from timings of the
products after the window.  A cell whose configuration has a ``mesh`` runs
as one process a card, which this command starts (``ranks.py``).  The
numbers that decided ``correct`` are the line's last key, ``checks``, and
the last lines of standard error.  Exits with 3, printing no result,
without enough cards, and with 4 when a JAX module was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness, manifest, nojax  # noqa: E402


def power_limit_w():
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def result_line(cell, res, device):
    line = {
        "correct": res["correct"],
        "attempted": res["attempted"],
        "failed": res["failed"],
        "metrics": {name: {"value": v, "unit": cell.units[name]}
                    for name, v in res["metrics"].items()},
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else device.type),
                   "count": cell.chips, "memory_peak_bytes": res["peak_bytes"]},
    }
    tr = res["trace"]
    if tr is not None:
        line["device"]["busy_s"] = tr["busy_s"]
        line["device"]["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["card"] = {"power_limit_w": power_limit_w()}
    line["checks"] = res["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); found {count}",
              file=sys.stderr)
        return 3
    if "mesh" in cell.config:
        from portbench import ranks

        return ranks.launch(args.workload, args.seed, args.seconds, args.trace, cell.chips,
                            t_start=T_START)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    started = time.perf_counter() - T_START
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                           t_start=T_START)
    return report(cell, res, device, started)


def report(cell, res, device, started) -> int:
    """The run's lines: the set-up parts, ``correct`` and each number
    compared beside its limit on standard error, then the result line;
    nothing, and 4, where a JAX module was loaded."""
    found = nojax.loaded()
    if found:
        print(f"portbench: JAX modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    line = result_line(cell, res, device)
    res["spans"]["imports_and_cuda_s"] = started
    print("set-up parts, and the window's solves " + json.dumps(res["spans"]), file=sys.stderr)
    print(f"correct {res['correct']} attempted {res['attempted']} failed {res['failed']}",
          file=sys.stderr)
    for name, c in res["checks"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
