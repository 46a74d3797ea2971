"""Quality metrics, the self-check, debug-mode invariant checks and profiling."""
