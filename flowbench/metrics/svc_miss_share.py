"""Of the checked steps' cache misses (StepResult.n_miss), the share the
Service LB resolved to a Service (StepResult.lb's lb): a drop means that
Service first packets stopped reaching the LB.  None where the program
reports no StepResult.lb."""


def read(rec):
    lb = [getattr(r, "lb", None) for r in rec["checked"].values()]
    if not lb or None in lb:
        return None
    miss = sum(r.n_miss for r in rec["checked"].values())
    return sum(c["lb"] for c in lb) / miss if miss else None
