"""Native (C++) runtime components + ctypes bindings: the journaled config
store (store.py over ovsdb_lite.cc), built with g++ on first use."""

from .store import ConfigStore, native_available

__all__ = ["ConfigStore", "native_available"]
