"""The benchmark's harness: drivers, traces, the yardstick, the checks."""
