"""One run of a cell: set-up, the measured window, the traced windows and
the check, as ``chipbench/run.py`` drives it.

1. Set-up (``setup_s``, from the start of the process to the first timed
   sweep): the tensor drawn on the first card from the seed
   (:mod:`chipbench.traffic.tensor`) and copied to the host as the port's
   ``SparseTensor``; ``api.plan``; ``api.compile`` onto the cell's logical
   devices; the traffic's warm-up sweeps.
2. The window: for ``seconds``, ``CPSolver.sweep()`` then a host read of
   its fit (the body of ``CPSolver.run`` without its stop). A sweep's time
   runs from one fit read to the next.
3. With ``trace``: sweeps under ``torch.profiler``, untraced and then with
   the port's span tracer on, and the program's registry just before and
   just after the untraced ones; the per-layer readers read them.
4. The check (:mod:`chipbench.check`): the state that enters the window's
   first sweep and the one it leaves are read back (``CPSolver.result()``,
   outside the timed intervals), and so is the last state of the run.
   Once the program's state is freed, the plain reference recomputes that
   first sweep from the entering factors, and works out from the nonzeros
   the normal equations that the last state's last mode has to solve.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from chipbench import check, profile, spec
from chipbench.reference import cp_als
from chipbench.traffic.tensor import draw_coo, scaled_geometry

__all__ = ["NoDevice", "ForbiddenModules", "Readings", "run",
           "forbidden_modules", "FORBIDDEN"]

# Top-level module names the measured process may not hold: JAX and the
# JAX package the port was made from (``repro_torch`` is not ``repro``).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = float(1 << 30)


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


class ForbiddenModules(RuntimeError):
    """The process loaded JAX or the JAX package."""


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Readings:
    """What a per-layer reader reads (``chipbench/metrics/<name>.py``)."""

    plan_s: float
    compile_s: float
    placed_bytes: int
    nnz: int
    shape: tuple
    rows_used: tuple      # rows of each mode that hold a nonzero
    rank: int
    num_devices: int
    cards: int
    untraced: list        # profile.Event of the untraced profiled sweeps
    traced: list          # profile.Event of the sweeps traced by the port
    traced_sweeps: int
    # obs.get_registry().report() just before and just after the untraced
    # profiled sweeps (counters, gauges, latency and every provider's
    # section, the solver's among them): the gauges set since the process
    # began, ``api.compile``'s too, and each counter's rise over those
    # sweeps. Both are taken before the traced sweeps reset the registry.
    registry_start: dict
    registry: dict


def _devices(cell: spec.Cell, device: str) -> tuple[list, list]:
    """(logical devices, cards) of the cell on ``device``."""
    if device == "cpu":
        return ["cpu"] * len(cell.config["devices"]), []
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoDevice(
            f"cell {cell.name} needs {chips} CUDA card(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count()={torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    devs = list(cell.config["devices"])
    cards = sorted({torch.device(d).index for d in devs})
    if len(cards) != chips:
        raise ValueError(f"cell {cell.name} lists {len(cards)} cards for "
                         f"{chips} chips")
    return devs, [torch.device("cuda", c) for c in cards]


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return "; ".join(out.stdout.strip().splitlines()) or "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run(name: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, root: Path = spec.ROOT, device: str = "cuda",
        control: bool = False, log=None) -> dict:
    """One run of cell ``name``; returns the result line's object. With
    ``control`` the object also holds the control's numbers
    (``"control"``), from the reference in TF32 on the same states.
    ``device="cpu"`` runs every logical device on the CPU and skips the
    look for a card (the tests' path)."""
    from repro_torch import api, obs
    from repro_torch.core.coo import SparseTensor
    from repro_torch.core.mttkrp import cp_mesh

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = spec.load_cell(name, root)
    devs, cards = _devices(cell, device)
    home = cards[0] if cards else torch.device("cpu")

    def sync():
        for c in cards:
            torch.cuda.synchronize(c)

    conf, traffic = cell.config, cell.traffic
    shape, draws = scaled_geometry(conf["shape"], conf["nnz"], conf["scale"],
                                   conf["mode_scale"])
    t_draw = time.perf_counter()
    ind, val = draw_coo(shape, draws, distribution=conf["distribution"],
                        zipf_a=conf.get("zipf_a", 1.0), seed=seed,
                        device=home)
    tensor = SparseTensor(ind, val, shape)
    del ind, val
    draw_s = time.perf_counter() - t_draw
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    cfg = api.preset(conf["preset"], {
        **conf["overrides"], "rank": conf["rank"],
        "runtime.num_devices": len(devs), "runtime.seed": seed % (1 << 64)})
    t0 = time.perf_counter()
    plan = api.plan(tensor, cfg, device=devs[0])
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = api.compile(plan, cfg, mesh=cp_mesh(len(devs), plan.modes[0].r,
                                                 devices=devs))
    sync()
    compile_s = time.perf_counter() - t0
    placed = sum(d.nbytes() for mode in solver.dev_arrays for d in mode)

    def step():
        return float(solver.sweep().fits[-1])

    t0 = time.perf_counter()
    for _ in range(int(traffic["warmup_sweeps"])):
        step()
    warm_s = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    log(f"{name} seed {seed}: shape {shape}, {draws} draws, nnz "
        f"{tensor.nnz}, rank {conf['rank']}, devices {devs}, r per mode "
        f"{[p.r for p in plan.modes]} | before the draw "
        f"{t_draw - t_start:.3f} s, draw {draw_s:.3f} s, plan {plan_s:.3f} "
        f"s, compile {compile_s:.3f} s, warm-up {warm_s:.3f} s, placed "
        f"{placed} B, setup {setup_s:.3f} s")

    entering = solver.result()

    # -- the window ---------------------------------------------------------
    # The first sweep is the one the reference recomputes: its output is
    # read back before the second (the pause is left out of the window),
    # since later sweeps drift into states where V is too ill-conditioned
    # for any float32 sweep to follow a float64 one (PERF.md). The later
    # ones are held to the normal equations of the last state.
    times: list[float] = []        # per sweep, seconds
    fits: list[float] = []
    t0 = time.perf_counter()
    fits.append(float(solver.sweep().fits[-1]))
    times.append(time.perf_counter() - t0)
    out = solver.result()
    t_prev = time.perf_counter()
    deadline = t_prev + seconds - times[0]
    while t_prev < deadline:
        fits.append(step())
        t = time.perf_counter()
        times.append(t - t_prev)
        t_prev = t
    sync()
    times[-1] += time.perf_counter() - t_prev
    peak = max((torch.cuda.max_memory_allocated(c) for c in cards),
               default=0)
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(
            f"the process holds {found} after the window closed")
    used = tuple(int(np.count_nonzero(np.bincount(tensor.indices[:, m],
                                                  minlength=s)))
                 for m, s in enumerate(shape))
    readings = None
    if trace:
        readings = _traced(traffic, sync, step, bool(cards),
                           plan_s=plan_s, compile_s=compile_s,
                           placed_bytes=placed, nnz=tensor.nnz, shape=shape,
                           rows_used=used,
                           rank=conf["rank"], num_devices=len(devs),
                           cards=len(cards))
    last = solver.result()
    solver.close()
    del solver, plan
    obs.reset()
    gc.collect()
    if cards:
        torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------
    t0 = time.perf_counter()
    ref = cp_als.sweep(tensor.indices, tensor.values, entering.factors,
                       device=home)
    numbers = check.gaps(out.factors, out.lam, out.fits[-1], ref)
    norm_x = float(np.linalg.norm(tensor.values.astype(np.float64)))
    m_end, v_end = cp_als.last_mode(tensor.indices, tensor.values,
                                    last.factors, device=home)
    numbers["end_solve_gap"] = cp_als.solve_gap(
        torch.from_numpy(last.factors[-1] * last.lam.astype(np.float64)),
        m_end, v_end)
    end_fit = cp_als.state_fit(m_end, v_end, last.factors[-1], last.lam,
                               norm_x)
    falls = -np.diff(last.fits)
    limits = cell.cell["limits"]
    bad_fits = sum(not math.isfinite(f) for f in fits)
    correct = check.judge(numbers, limits) and bad_fits == 0
    log(f"check: reference {time.perf_counter() - t0:.3f} s; first sweep "
        f"fit {out.fits[-1]!r} (reference {ref[2]!r}); last fit "
        f"{last.fits[-1]!r} after {last.sweeps} sweeps (the reference's fit "
        f"of that state {end_fit!r}); largest fall of the fit from one "
        f"sweep to the next {float(falls.max(initial=0.0))!r}, after sweep "
        f"{int(np.argmax(falls)) + 1 if falls.size else 0}; largest lam "
        f"{float(np.max(np.abs(last.lam)))!r}; non-finite fits {bad_fits} "
        f"of {len(fits)}")

    window_s = float(sum(times))
    half = len(times) // 2
    log(f"window: {len(times)} sweeps in {window_s:.3f} s; sweep ms "
        f"quartiles {[round(1e3 * q, 4) for q in np.percentile(times, [25, 50, 75])]}, "
        f"first half mean {1e3 * np.mean(times[:half]):.4f}, second half "
        f"mean {1e3 * np.mean(times[half:]):.4f}; peak {peak} B; rows "
        f"holding a nonzero {used}")
    result: dict = {
        "correct": bool(correct),
        "attempted": len(times),
        "failed": bad_fits + (0 if check.judge(numbers, limits) else 1),
    }
    if trace:
        values = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"], root)(readings)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = {"sweep_ms": 1e3 * window_s / len(times),
               "sweep_p95_ms": 1e3 * float(np.percentile(times, 95)),
               "device_peak_gib": peak / GIB,
               "setup_s": setup_s}
        values = {m["name"]: {"value": float(e2e[m["name"]]),
                              "unit": m["unit"]} for m in cell.end_to_end}
    result["metrics"] = values
    result["device"] = {
        "platform": "gpu" if cards else "cpu",
        "kind": torch.cuda.get_device_name(cards[0]) if cards else "cpu",
        "count": len(cards), "memory_peak_bytes": int(peak)}
    if trace:
        for span in ("ec", "exchange"):
            log(f"device work in the traced sweeps' {span} spans, seconds "
                f"over {readings.traced_sweeps} sweeps: "
                f"{profile.ops_within(readings.traced, span)}")
        ev = readings.untraced
        if cards and profile.cards(ev):
            w0, w1 = profile.window(ev)
            busy = [sum(b - a for a, b in profile.busy(ev, c))
                    for c in profile.cards(ev)]
            result["device"].update(busy_s=float(np.mean(busy)) / 1e9,
                                    window_s=(w1 - w0) / 1e9)
            result["breakdown"] = {"device_ops": profile.top_ops(ev),
                                   "idle_gaps": profile.idle_gaps(ev)}
    if control:
        ctl = cp_als.sweep(tensor.indices, tensor.values, entering.factors,
                           device=home, precision="tf32")
        result["control"] = check.gaps(*ctl, ref)
        m32, v32 = cp_als.last_mode(tensor.indices, tensor.values,
                                    last.factors, device=home,
                                    precision="tf32")
        result["control"]["end_solve_gap"] = cp_als.solve_gap(
            cp_als.tf32_solve(m32, v32), m_end, v_end)
    if cards:
        log(f"cards: {_power_limit()}")
    result["checks"] = {k: {"value": numbers[k] if math.isfinite(numbers[k])
                            else None, "limit": limits[k]}
                        for k in check.NAMES}
    return result


def _traced(traffic, sync, step, cuda: bool, **facts) -> Readings:
    """The untraced and the traced profiled windows."""
    from repro_torch import obs
    n_plain = int(traffic["profiled_sweeps"])
    n_traced = int(traffic["traced_sweeps"])
    # No provider of the registry launches work or synchronises a card
    # (the solver's ``exchange`` section is the model's, measure=False).
    registry_start = obs.get_registry().report()
    untraced = profile.capture(step, n_plain, sync, cuda=cuda)
    registry = obs.get_registry().report()
    obs.reset()
    obs.trace.enable()
    try:
        traced = profile.capture(step, n_traced, sync, cuda=cuda)
    finally:
        obs.reset()
    return Readings(untraced=untraced, traced=traced,
                    traced_sweeps=n_traced, registry_start=registry_start,
                    registry=registry, **facts)
