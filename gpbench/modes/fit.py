"""fit: whole days of execute_buckets(optimise=True, predict=True) on the
configuration's target days in turn, one day a unit; a new day starts only
while fewer than --seconds have passed, and the day in flight finishes. One
caller, closed loop. Set-up warms every level up on a few experts of each
(the mix's warm_experts_per_level)."""

from gpbench import generator, harness, verify


def target_days(dep):
    return dep["target_days"]


def setup(ctx):
    ctx.prog.day(harness.warm_subset(ctx.days,
                                     ctx.traffic["warm_experts_per_level"]))
    harness.sync(ctx.device)
    ctx.mark("warm-up")
    ctx.state["last"] = {}


def unit(ctx, i):
    j = i % len(ctx.days)
    u, ctx.state["last"][j] = harness.timed(ctx, ctx.days[j], "day")
    return u


def check(ctx, seed):
    last = ctx.state["last"]
    return verify.check_fit_days(
        ctx.cfg, ctx.model, [(ctx.days[j], last[j]) for j in sorted(last)],
        seed, ctx.checks["sample_per_level"], ctx.device)


def _days(spec, seed):
    dep = spec["config"]["deployment"]
    obs = generator.observations(seed, dep)
    return [generator.day_inputs(obs, dep, d) for d in target_days(dep)]


def control(spec, seed, device):
    """The control's readings on the experts a run samples from every
    target day."""
    return verify.control_fit_days(spec["config"], spec["model"],
                                   _days(spec, seed), seed,
                                   spec["checks"]["sample_per_level"], device)


def fault(spec, seed, device):
    """The readings with the fit broken underneath: every day run with
    optimise=False, each expert left at the program's start (the fault "a
    step that returns its state unchanged")."""
    prog = harness.Program(spec["config"], device,
                           spec["traffic"].get("execute"))
    days = [(inp, prog.day(inp, optimise=False))
            for inp in _days(spec, seed)]
    prog = None
    numbers = verify.check_fit_days(spec["config"], spec["model"], days, seed,
                                    spec["checks"]["sample_per_level"],
                                    device)
    numbers.pop("_worst")
    return numbers
