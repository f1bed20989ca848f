"""The host's side of a request: the package's ``request`` span around each
``process_images`` call less the ``wait_device`` spans nested in it on its
thread (``request.host``), per request (milliseconds).  The package keeps
its spans while the profiler runs: the traced run."""


def read(ctx):
    host, request = ctx.stats.get("request.host"), ctx.stats.get("request")
    if not host or not request or not request["calls"]:
        return None
    return 1e3 * host["seconds"] / request["calls"]
