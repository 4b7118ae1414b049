"""Real rows over all rows of the batches sent to the card in the
untraced window (the CLI's filler rows are the rest); a count."""


def read(r):
    if r.kind != "enhance" or r.rows_total == 0:
        return None
    return 100.0 * r.rows_real / r.rows_total
