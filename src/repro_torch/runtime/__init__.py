"""Runtime guards of the port (port of `repro.runtime`: the capture guard)."""
