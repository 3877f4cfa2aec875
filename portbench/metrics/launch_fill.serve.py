"""launch_fill.serve: the server's real rows over its bucket rows, every
launch of the window, from `PhenakiServer.launch_log` ((requests, bucket) a
launch, a program record)."""


def read(ctx):
    log = ctx.get("launch_log") or []
    rows = sum(bucket for _, bucket in log)
    return 100.0 * sum(n for n, _ in log) / rows if rows else None
