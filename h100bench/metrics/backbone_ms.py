"""Device ms per request or train step of the operations launched inside
the ``backbone_net`` forward span (a train step's backward runs on the
autograd engine's thread, outside it)."""


def read(r):
    ops = r.trace.launched_in(r.trace.spans_named("h100bench.backbone_net"),
                              r.trace.in_steps())
    return sum(o.end - o.ts for o in ops) / 1e3 / r.steps if ops else None
