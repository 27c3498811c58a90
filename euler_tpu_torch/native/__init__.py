"""Native host core of the port (ctypes over the package's own
csrc/euler_core.cc)."""
