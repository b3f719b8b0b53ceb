"""Of the lanes the one-pass classify took (the window's delta of
prune_stats()' classified_total), the share that fell back to the
full-width walk through B1 (its fallbacks_total)."""


def read(rec):
    p = rec.get("prune") or {}
    c = p.get("classified_total", 0)
    return p.get("fallbacks_total", 0) / c if c else None
