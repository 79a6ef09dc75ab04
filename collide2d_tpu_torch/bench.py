"""The bench headline on one card: ``python -m collide2d_tpu_torch.bench``.

The counterpart of the repository's root ``bench.py`` headline contract:

- the two bandwidth probes run first: kernel 16, the SAT count's exact
  memory pattern with trivial math (`bench_stream_bandwidth_cuda`), then
  torch's own reduction (`bench_reduce_bandwidth`); each prints
  '# '-prefixed on stderr;
- the headline is the SAT count kernel (kernel 3) at 2^23 pairs x 100
  calls: ``sat_rect_pairs_per_sec`` with ``effective_gbps`` (the 64 B a
  pair it reads) and ``hbm_read_gbps`` (the larger probe); an implied
  bandwidth above 1.15 x the probe marks ``bandwidth_check`` FAILED (the
  timing, not the card, would be at fault), else ``ok``;
- the headline JSON prints at once, then `run_all`'s legs '# '-prefixed on
  stderr (a leg that fails prints its error there and the others go on),
  then the headline once more as the last stdout line.

It needs a card: without one it exits non-zero before measuring anything.
Exit code 0 when every leg ran, 1 when one failed (the headline still
prints last).
"""

from __future__ import annotations

import json
import sys
import traceback

import torch

from collide2d_tpu_torch.utils import benchmarks as bm

BANDWIDTH_SLACK = 1.15  # as bench.py: noise on the probe, not a real excess


def _log(obj) -> None:
    print("# " + json.dumps(obj), file=sys.stderr, flush=True)


def headline(log=_log) -> dict:
    """Run the probes, then the SAT headline, and check the headline's
    implied bandwidth against the larger probe."""
    hbm_gbps = 0.0
    for probe in (bm.bench_stream_bandwidth_cuda, bm.bench_reduce_bandwidth):
        res = probe()
        log(res)
        hbm_gbps = max(hbm_gbps, res["value"])
    sat = bm.bench_sat_cuda(pairs=1 << 23, iters=100)
    out = {
        "metric": "sat_rect_pairs_per_sec",
        "value": sat["value"],
        "unit": "pairs/s",
        "vs_baseline": sat["vs_baseline"],
        "effective_gbps": sat["effective_gbps"],
        "hbm_read_gbps": hbm_gbps,
    }
    if sat["effective_gbps"] > BANDWIDTH_SLACK * hbm_gbps:
        print(f"# WARNING: implied bandwidth {sat['effective_gbps']:.0f} GB/s "
              f"exceeds measured streaming bandwidth {hbm_gbps:.0f} GB/s - "
              "timing methodology suspect", file=sys.stderr, flush=True)
        out["bandwidth_check"] = "FAILED"
    else:
        out["bandwidth_check"] = "ok"
    out["device"] = sat["device"]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("collide2d_tpu_torch.bench: no CUDA device (the bench measures "
              "the card; the CPU legs run through `collide2d-torch bench "
              "--device cpu`)", file=sys.stderr)
        return 2
    head = headline()
    line = json.dumps(head)
    print(line, flush=True)  # at once, in case a later leg is cut off
    failed = 0
    for name, fn in bm.legs():
        try:
            _log(fn())
        except Exception:  # noqa: BLE001 — reported, the headline stands
            failed += 1
            trace = traceback.format_exc().rstrip().replace("\n", "\n# ")
            print(f"# {name} failed:\n# {trace}", file=sys.stderr, flush=True)
    _log(bm.LEARNED_SKIP)
    print(line, flush=True)  # the contract: the headline is the last line
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
