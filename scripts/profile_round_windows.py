"""Which profiled window keeps a warm decode round's copy records on the
card. Runs ``chip_smoke.py``'s main() through its four serve paths
(bf16 and int8 arenas, yi-6b and zamba2-2.7b) and stops before the
statement paths; at each path's warm-round check it profiles warm rounds
(no block boundary) in several window layouts, twice each, and prints a
``WINDOW`` JSON line a window: the copy records dated inside the
measured round, those its host calls issued (by correlation id), when
the first device record inside it starts, the copy records
of the whole window (µs from the round's start), and the host time of
the round's ``cudaGraphLaunch``. Layouts:

* ``bare``: the round alone;
* ``bare_pre``: a kernel and a copy each way open the window;
* ``settle``, ``settle_pre``: the same after a throwaway session;
* ``two_rounds``: a first warm round opens the window, the second is
  measured (what ``chip_smoke.round_calls`` does).

Run on a CUDA card from the repository's root::

    python3 scripts/profile_round_windows.py
"""
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

LAYOUTS = ("bare", "bare_pre", "settle", "settle_pre", "two_rounds")


def settle():
    """A throwaway profiler session with one kernel."""
    CS.sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda")
        CS.sync()


def window(eng, layout: str) -> dict:
    if layout.startswith("settle"):
        settle()
    CS.sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if layout == "two_rounds":
            eng.decode_round()
        else:
            torch.zeros(1, device="cuda")
            if layout.endswith("_pre"):
                torch.ones(1).pin_memory().to("cuda", non_blocking=True).cpu()
        CS.sync()
        with record_function("decode_round"):
            eng.decode_round()
        CS.sync()
    ev = prof.events()
    span = next(e for e in ev if e.name == "decode_round"
                and e.device_type != DeviceType.CUDA).time_range
    dev = [e for e in ev if e.device_type == DeviceType.CUDA]
    inside = [e for e in dev if span.start <= e.time_range.start <= span.end]
    launch = [e.time_range.elapsed_us() for e in ev
              if e.name == "cudaGraphLaunch" and e.device_type != DeviceType.CUDA
              and span.start <= e.time_range.start <= span.end]
    issued = CS.round_copies(prof, "decode_round")[1]
    return {
        "layout": layout, "engine": eng.cfg.name,
        "int8": bool(eng.cfg.kv_quant_int8),
        "copies_in_round": {k: sum(k in e.name for e in inside
                                   if "Memcpy" in e.name)
                            for k in ("HtoD", "DtoH")},
        "copies_issued_in_round": {k: issued[k] for k in ("HtoD", "DtoH")},
        "first_record_in_round_us": min(
            (round(e.time_range.start - span.start, 1) for e in inside),
            default=None),
        "window_copies_us": [(e.name[7:11], round(e.time_range.start
                                                   - span.start, 1))
                             for e in dev if "Memcpy" in e.name
                             and "DtoD" not in e.name],
        "graph_launch_host_us": [round(x, 1) for x in launch],
        "round_us": round(span.end - span.start, 1)}


def warm_round_calls(eng, tries=3):
    """Replaces chip_smoke's check: every layout twice, then the counts
    chip_smoke expects, so that its path goes on."""
    rounds = 0
    for _ in range(2):
        for layout in LAYOUTS:
            while any(eng.lengths[s] % CS.SERVE_BLOCK in (0, CS.SERVE_BLOCK - 1)
                      for s in eng.requests):
                eng.decode_round()
                rounds += 1
            print("WINDOW " + json.dumps(window(eng, layout)), flush=True)
            rounds += 2 if layout == "two_rounds" else 1
    return dict.fromkeys(CS.LAUNCH_CALLS, 0) | {
        "cudaGraphLaunch": 1, "cudaMemcpyAsync": 2}, rounds


def stop(*a, **k):
    raise SystemExit(0)


if __name__ == "__main__":
    CS.warm_round_calls = warm_round_calls
    CS.phase_table2 = stop   # the first statement path
    CS.main()
