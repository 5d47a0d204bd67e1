"""repredict: run_examples.sh step 6. Set-up fits the first target day;
each pass, one unit, smooths every fitted hyperparameter field with
smooth_field on the card and re-predicts the day with
execute_buckets(optimise=False, overrides=smoothed). Passes repeat until
--seconds have passed, whole passes only."""

import time

from gpbench import generator, harness, verify


def target_days(dep):
    return dep["target_days"][:1]


def setup(ctx):
    inp = ctx.days[0]
    ctx.state["fitted"] = ctx.prog.day(inp)
    harness.sync(ctx.device)
    ctx.mark("fit of the day")
    ctx.prog.day(inp, optimise=False, overrides=ctx.prog.smooth(
        ctx.cfg, inp["experts"], ctx.state["fitted"]["params"]))
    harness.sync(ctx.device)
    ctx.mark("warm-up")


def unit(ctx, i):
    inp = ctx.days[0]
    t0 = time.perf_counter()
    smoothed = ctx.prog.smooth(ctx.cfg, inp["experts"],
                               ctx.state["fitted"]["params"])
    harness.sync(ctx.device)
    t_s = time.perf_counter()
    u, out = harness.timed(ctx, inp, "pass", overrides=smoothed,
                           optimise=False)
    u.update(t0=t0, seconds=u["t1"] - t0, smooth_s=t_s - t0)
    ctx.state["last"], ctx.state["smoothed"] = out, smoothed
    return u


def check(ctx, seed):
    s = ctx.state
    return verify.check_repredict(
        ctx.cfg, ctx.model, ctx.days[0], s["fitted"], s["smoothed"],
        s["last"], seed, ctx.checks["sample_per_level"], ctx.device)


def control(spec, seed, device):
    """The control's readings, from the program's fit of the first target
    day (the state the window starts from), which this runs first."""
    dep = spec["config"]["deployment"]
    inp = generator.day_inputs(generator.observations(seed, dep), dep,
                               target_days(dep)[0])
    prog = harness.Program(spec["config"], device,
                           spec["traffic"].get("execute"))
    fitted = prog.day(inp)
    prog = None
    return verify.control_repredict(spec["config"], spec["model"], inp,
                                    fitted, seed,
                                    spec["checks"]["sample_per_level"],
                                    device)
