"""Device ms per train step of the operations that the autograd engine
launched (inside its ``evaluate_function`` events)."""


def read(r):
    ops = r.trace.launched_in(r.trace.engine_functions(), r.trace.in_steps())
    return sum(o.end - o.ts for o in ops) / 1e3 / r.steps if ops else None
