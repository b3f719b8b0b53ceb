"""A census of the device->host syncs that code performs on the card.

    with SyncCensus() as census:
        eng.step(batch, now)
    census.sites          # Counter {(package path, function key): syncs}
    census.undeclared()   # models/ and ops/ sites no HOST_SYNCS row names

While active, `torch.cuda.set_sync_debug_mode("warn")` makes every
synchronizing CUDA call (a read-back, a data-sized result, an upload from
pageable host memory, a stream or device synchronize) raise a warning;
the census catches each one and attributes it to the innermost frame
inside antrea_tpu_torch/ on the stack, keyed as the analysis plane's
host-sync pass keys its HOST_SYNCS rows (analysis/host_sync.site_key:
"function" or "Class.method").  Lambdas and generator expressions are
attributed to the function around them.  The mode changes no result: it
only adds the check on the host.

torch is imported when the census starts, never at import."""

from __future__ import annotations

import collections
import pathlib
import sys
import warnings

from ..analysis import host_sync

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
_SELF = pathlib.Path(__file__).resolve()

# The text torch's sync debug mode warns with.
SYNC_MESSAGE = "synchronizing CUDA operation"


def _site(frame):
    """-> (package path, function key, line) of the innermost frame inside
    the package (this module's own frames and <lambda> / <genexpr> frames
    skipped), or None."""
    while frame is not None:
        path = pathlib.Path(frame.f_code.co_filename)
        if (not frame.f_code.co_name.startswith("<") and path != _SELF
                and path.is_relative_to(PKG_DIR)):
            rel = path.relative_to(PKG_DIR).as_posix()
            return (rel, host_sync.site_key(frame.f_code.co_qualname),
                    frame.f_lineno)
        frame = frame.f_back
    return None


class SyncCensus:
    """Counts the syncs of the code run inside it, by site (see the module
    docstring).  `frame_matches` counts the syncs whose warning itself
    named the attributed frame's file and line (the warning carries the
    caller's Python frame); `unattributed` those with no package frame on
    the stack."""

    def __init__(self):
        self.sites: collections.Counter = collections.Counter()
        self.lines: collections.Counter = collections.Counter()
        self.unattributed = 0
        self.frame_matches = 0
        self._saved = None

    def __enter__(self):
        import torch

        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        self._show = warnings.showwarning
        warnings.showwarning = self._hook
        self._saved = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode(self._saved)
        self._catch.__exit__(*exc)

    def _hook(self, message, category, filename, lineno, file=None,
              line=None):
        if SYNC_MESSAGE not in str(message):
            self._show(message, category, filename, lineno, file, line)
            return
        site = _site(sys._getframe(1))
        if site is None:
            self.unattributed += 1
            return
        rel, key, at = site
        self.sites[rel, key] += 1
        self.lines[rel, key, at] += 1
        if (pathlib.Path(filename).resolve() == PKG_DIR / rel
                and lineno == at):
            self.frame_matches += 1

    @property
    def total(self) -> int:
        return sum(self.sites.values()) + self.unattributed

    def held(self) -> dict:
        """{(path, key): syncs} of the sites the host-sync pass scans
        (models/, ops/)."""
        return {k: n for k, n in self.sites.items()
                if k[0].startswith(host_sync.SCOPE)}

    def undeclared(self, declared=None) -> dict:
        """The held sites at a function no HOST_SYNCS row of its module
        declares.  declared: analysis.host_sync.declared(root), by default
        of the tree this package lies in."""
        if declared is None:
            declared = host_sync.declared(PKG_DIR.parent)
        return {(rel, key): n for (rel, key), n in self.held().items()
                if key not in declared.get(rel, {})}
