"""The paper's figure checks on the port: Figs. 2-5 (``paper_figures``)
and Figs. 6-11 (``blended_workloads``), each a module that runs as

    python -m repro_torch.figures.<name> --device {cuda,cpu}

prints ``[PASS]/[FAIL]`` per figure with its checks, writes its CSV/JSON
evidence under ``build/figures/`` (``REPRO_BENCH_OUT`` overrides) and
exits 1 when a check fails.  Sizes, seeds counts and thresholds are the
reference benchmarks'."""
