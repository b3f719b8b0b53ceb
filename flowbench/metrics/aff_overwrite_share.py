"""Of the pins the checked steps wrote (StepResult.lb's aff_learn), the
share that overwrote a live pin of another (client, Service) key in the
direct-mapped learn table (its aff_overwrite): each breaks the ClientIP
guarantee of the pin it overwrites.  None where the program reports no
StepResult.lb."""


def read(rec):
    lb = [getattr(r, "lb", None) for r in rec["checked"].values()]
    if not lb or None in lb:
        return None
    n = sum(c["aff_learn"] for c in lb)
    return sum(c["aff_overwrite"] for c in lb) / n if n else None
