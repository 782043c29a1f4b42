"""How unevenly the router spreads the rows: from the server's
`expert_rows` counter (rows each expert took in each routed layer over
the run's decode steps, summed on the device and copied to the host with
each batch's lengths), the mean over the layers of the busiest expert's
rows over the mean expert's. 1 is an even spread; the grouped products'
time follows the busiest. None on a program without the counter."""


def read(ctx):
    rows = ctx.counters.get("stats", {}).get("expert_rows")
    if not rows:
        return None
    shares = [max(r) / (sum(r) / len(r)) for r in rows if sum(r)]
    return sum(shares) / len(shares) if shares else None
