"""The benchmark's harness: reading `BENCHMARK.json` and the files it names,
the seeded weights, the port under test and its spans, the profiler window,
the peaks and the operation counts, the comparison that decides `correct`."""
