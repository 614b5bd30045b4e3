"""``collective_pct``: the share of a profiled solve's device busy time in
which one of NCCL's kernels ran (layer: exchange, ``parallel/exchange.py``'s
gathers of the blocks' partials): 100 collective / busy, each the union of
the card's intervals inside the solve (``profile.summarize``), on each
rank; the largest over the ranks.  A kernel that waits for a peer counts as
busy, so ``idle_pct`` cannot see the exchange; this can.  Nothing where no
card ran a collective."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    shares = [100.0 * r["collective_s"] / r["busy_s"] for r in tr.get("ranks", [tr])
              if r["device_events"] and r["busy_s"] > 0 and r["collective_s"] > 0]
    return max(shares) if shares else None
