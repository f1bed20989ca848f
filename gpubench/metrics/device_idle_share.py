"""Share of the traced window in which a card ran no kernel, copy or set,
averaged over the cards the cell uses (percent)."""


def read(ctx):
    if not ctx.summary or not ctx.summary["busy"] or not ctx.window_s:
        return None
    busy = [ctx.summary["busy"].get(i, 0.0) for i in range(ctx.cards)]
    return 100.0 * sum(1.0 - b / ctx.window_s for b in busy) / ctx.cards
