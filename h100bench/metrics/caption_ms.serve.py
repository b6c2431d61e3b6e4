"""Device ms per request of the operations launched inside the
``caption`` forward span: the free-running decode of
every proposal."""


def read(r):
    ops = r.trace.launched_in(r.trace.spans_named("h100bench.caption"),
                              r.trace.in_steps())
    return sum(o.end - o.ts for o in ops) / 1e3 / r.steps if ops else None
