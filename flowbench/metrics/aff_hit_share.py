"""Of the checked steps' classified misses to Services with ClientIP
affinity (StepResult.lb's lb_aff), the share a live pin decided (its
aff_hit).  None where the program reports no StepResult.lb."""


def read(rec):
    lb = [getattr(r, "lb", None) for r in rec["checked"].values()]
    if not lb or None in lb:
        return None
    n = sum(c["lb_aff"] for c in lb)
    return sum(c["aff_hit"] for c in lb) / n if n else None
