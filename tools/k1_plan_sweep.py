"""Measures the fused diffusion kernels' (K1-K3's) plan table on the card:
times K1 at every plan of both layouts (cells and strips) on each case,
then the fastest few in turns, and prints each instance's registers,
spills and most threads a block as the card reports them.

For each case it first holds every plan's trajectory and end over a few
steps against the plain version (within 1e-5 of max|y|: the plain
version's ``x / 6.0`` on the card is a multiplication by the reciprocal,
which :func:`division_rounding` counts, where the kernel divides) and
against the plan :func:`make_k1_plan` picks (0.0: every plan computes the
same operations in the same order), then times the trajectory (or, for
the batched case, the end) at each plan, and prints the fastest of each
layout, which ``_MEASURED_PLANS`` of ``ops/fused_diffusion.py`` records,
beside the plan :func:`make_k1_plan` picks. Plans of one case a few per
cent apart trade places from call to call, so :func:`turns` then times
each case's fastest three, the fastest of each layout and the chosen
plan in turns (a, b, c, c, b, a, three times over) and prints each
one's mean and range: the winner of the turns is the table's entry.

The cases: the flagship's 21 x 21 (bench.py's ``build_problem``, d_t
1e-3), the 17 x 17 convection-diffusion problem of
``tests/test_fused_diffusion.py``, a non-square 17 x 40 grid, 3 x 3, 51
x 51 and 104 x 104 (the largest square ``fits_one_block`` admits), each
as a trajectory of 2,000 steps, and the flagship's B = 8 end over 5,000
steps (one Parareal iteration's fine ends).

Run it from the repository root on a machine with one CUDA card:
``python3 tools/k1_plan_sweep.py [results.json]`` (about three
minutes).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import pararealml_tpu_torch as prml  # noqa: E402
from pararealml_tpu_torch.ops import fused_diffusion as fd  # noqa: E402

STEPS = 2000
END_STEPS = 5000
END_BATCH = 8
CHECK_STEPS = 5
D_T = 1e-3
# the grids swept besides the flagship and the convection problem
GRIDS = ((17, 40), (3, 3), (51, 51), (104, 104))


def cases(device):
    """(label, config, states ((B, H, W) on the card), batched) of each
    case."""
    problems, initial = chip_smoke.kernel_problems(prml)

    def state(label):
        return torch.as_tensor(
            initial[label].discrete_y_0(True)[..., 0],
            dtype=torch.float32,
            device=device,
        )[None].contiguous()

    flagship = fd._KernelConfig(problems["flagship"], D_T)
    yield "flagship 21x21", flagship, state("flagship"), False
    yield (
        "convection 17x17",
        fd._KernelConfig(problems["convection"], D_T),
        state("convection"),
        False,
    )
    rng = np.random.default_rng(0)
    for height, width in GRIDS:
        ys = torch.as_tensor(
            rng.uniform(0.0, 2.0, (1, height, width)),
            dtype=torch.float32,
            device=device,
        )
        yield (
            f"grid {height}x{width}",
            fd._KernelConfig(
                chip_smoke.grid_problem(prml, height, width), D_T
            ),
            ys,
            False,
        )
    y = state("flagship")[0]
    slices = torch.stack(
        [y * (0.5 + 0.125 * i) + 0.1 * i for i in range(END_BATCH)]
    ).contiguous()
    yield f"flagship 21x21 ends B={END_BATCH}", flagship, slices, True


def instance_rows(log, card):
    """Logs and returns each built instance's registers, spill bytes and
    most threads a block, with and without convection."""
    rows = []
    instances = [("cells", cells) for cells in fd.CELLS_INSTANCES]
    for layout, cells in instances + [("strips", 0)]:
        for convection in (False, True):
            registers, spills, threads = fd.instance_attributes(
                layout, cells, convection
            )
            rows.append(
                dict(
                    instance=[layout, cells, convection],
                    registers=registers,
                    spill_bytes=spills,
                    max_threads=threads,
                )
            )
            log(
                f"instance: {layout} {cells}, convection {convection}: "
                f"{registers} registers, {spills} spill bytes, at most "
                f"{threads} threads [{card}]"
            )
    return rows


def division_rounding(device, log, card):
    """How often the plain version's division by the Python scalar 6.0
    on the card differs from a true division (by a tensor of 6.0s): the
    kernel divides truly, so where they differ the kernel and its plain
    version part by a rounding."""
    x = torch.rand(1 << 20, device=device)
    differ = int(((x / 6.0) != (x / torch.full_like(x, 6.0))).sum())
    log(
        f"plain division: x / 6.0 differs from a true division in "
        f"{differ} of {x.numel()} float32 values [{card}]"
    )
    return differ


def _kernel(cfg, ys, batched, n_steps, plan):
    """The timed call of a case on ``plan``: the B = 8 end, or the
    trajectory."""
    if batched:
        return lambda: fd.fused_diffusion_rk4_end(ys, cfg, n_steps, plan=plan)
    return lambda: fd.fused_diffusion_rk4_trajectory(
        ys, cfg, n_steps, plan=plan
    )


def run(device, card, log=print):
    fd.load_kernels()
    results = dict(
        instances=instance_rows(log, card),
        division_differs=division_rounding(device, log, card),
        cases=[],
    )
    for label, cfg, ys, batched in cases(device):
        n_steps = END_STEPS if batched else STEPS
        chosen = cfg.plan(ys.shape[0])
        expected = fd.fused_diffusion_rk4_trajectory_reference(
            ys, cfg, CHECK_STEPS
        )
        scale = float(expected.abs().max())
        # every plan computes the same operations in the same order: each
        # equals the chosen plan bit for bit
        same = fd.fused_diffusion_rk4_trajectory(ys, cfg, CHECK_STEPS)
        rows = []
        for plan in fd.k1_plans(cfg.height, cfg.width):
            out = fd.fused_diffusion_rk4_trajectory(
                ys, cfg, CHECK_STEPS, plan=plan
            )
            end = fd.fused_diffusion_rk4_end(ys, cfg, CHECK_STEPS, plan=plan)
            torch.cuda.synchronize()
            error = max(
                float((out - expected).abs().max()),
                float((end - expected[:, -1]).abs().max()),
            )
            apart = max(
                float((out - same).abs().max()),
                float((end - same[:, -1]).abs().max()),
            )
            if not (error <= chip_smoke.KERNEL_REL_TOL * scale and apart == 0):
                raise AssertionError(
                    f"{label}: {plan} differs from plain ({error:.3e}) or "
                    f"from the chosen plan ({apart:.3e})"
                )
            ms = chip_smoke.cuda_ms(
                torch, _kernel(cfg, ys, batched, n_steps, plan)
            )
            rows.append(
                dict(
                    plan=str(plan),
                    layout=plan.layout,
                    threads=plan.threads,
                    cells=plan.cells,
                    step_us=1e3 * ms / n_steps,
                    max_abs_err=error,
                    max_abs_from_chosen=apart,
                )
            )
            log(
                f"sweep: {label}: {plan}: {1e3 * ms / n_steps:.3f} us a "
                f"step, max|d| vs plain {error:.3e} (max|y| {scale:.3e}), "
                f"vs the chosen plan {apart:.1e} [{card}]"
            )
        for layout in ("cells", "strips"):
            own = [row for row in rows if row["layout"] == layout]
            if own:
                best = min(own, key=lambda row: row["step_us"])
                log(
                    f"sweep: {label}: fastest {layout} {best['plan']} "
                    f"{best['step_us']:.3f} us a step [{card}]"
                )
        best = min(rows, key=lambda row: row["step_us"])
        log(
            f"sweep: {label}: fastest {best['plan']} {best['step_us']:.3f} "
            f"us a step; make_k1_plan's choice {chosen} [{card}]"
        )
        results["cases"].append(
            dict(
                case=label,
                shape=[cfg.height, cfg.width],
                steps=n_steps,
                batch=ys.shape[0] if batched else None,
                chosen=str(chosen),
                rows=rows,
            )
        )
    return results


def turns(device, card, results, log=print, top=3, reps=3):
    """Times each case's ``top`` fastest plans of the sweep (``results``,
    from :func:`run`), the fastest of each layout and the plan
    :func:`make_k1_plan` picks, in turns (a, b, c, c, b, a, ``reps``
    times over); logs and returns one dict a case with each plan's mean,
    least and most µs a step."""
    out = []
    for (label, cfg, ys, batched), case in zip(
        cases(device), results["cases"]
    ):
        n_steps = case["steps"]
        by_name = {
            str(plan): plan for plan in fd.k1_plans(cfg.height, cfg.width)
        }
        ranked = sorted(case["rows"], key=lambda row: row["step_us"])
        names = [row["plan"] for row in ranked[:top]]
        for layout in ("cells", "strips"):
            own = [row for row in ranked if row["layout"] == layout]
            if own:
                names.append(own[0]["plan"])
        names.append(case["chosen"])
        names = list(dict.fromkeys(names))
        times = {name: [] for name in names}
        for _ in range(reps):
            for name in names + names[::-1]:
                ms = chip_smoke.cuda_ms(
                    torch, _kernel(cfg, ys, batched, n_steps, by_name[name])
                )
                times[name].append(1e3 * ms / n_steps)
        rows = [
            dict(
                plan=name,
                mean_us=sum(t) / len(t),
                min_us=min(t),
                max_us=max(t),
                all_us=t,
            )
            for name, t in times.items()
        ]
        winner = min(rows, key=lambda row: row["mean_us"])
        out.append(
            dict(
                case=label,
                chosen=case["chosen"],
                winner=winner["plan"],
                rows=rows,
            )
        )
        log(
            f"turns: {label}, {n_steps} steps: "
            + ", ".join(
                f"{row['plan']} {row['mean_us']:.3f} us a step "
                f"({row['min_us']:.3f}-{row['max_us']:.3f})"
                for row in rows
            )
            + f" (means of {2 * reps} turns); winner {winner['plan']}, "
            f"make_k1_plan's choice {case['chosen']} [{card}]"
        )
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_plan_sweep.py needs a CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    device = torch.device("cuda", 0)
    results = run(device, card)
    results["turns"] = turns(device, card, results)
    paths = sys.argv[1:]
    if paths:
        with open(paths[0], "w") as f:
            json.dump(dict(card=card, **results), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
