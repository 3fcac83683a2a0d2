"""Host microseconds a simulated event costs the trainer's event loop
before dispatch: the self time of the program's ``sim.events`` spans
(pulling events from the scheduler's stream up to a flush) and
``sim.pack`` spans (packing them into a block's arrays) over the traced
window's events, read from the program's span table."""
from portbench import spantable


def read(ctx):
    calls = sum(1 for n, _, _ in ctx["window"].host if n == "sim.run")
    win = spantable.window("sim.run", calls)
    if not win or not ctx.get("events"):
        return None
    own = spantable.seconds(win, ("sim.events", "sim.pack"), own=True)
    return 1e6 * own / ctx["events"]
