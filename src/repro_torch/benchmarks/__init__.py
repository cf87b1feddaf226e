"""The paper-scale harness of the port: the offline replay of the paper's
experiments (``common.run_policy``), the paced ``PoolServer`` drive over
``SimEngine``s (``common.drive_pool_stream``), the closed-loop scenario
drive (``common.run_scenario``, ``run_record``), the baselines table and
closed loop (``baselines.run``, ``run_closed_loop``), the RouterBench
scorecard and closed loop (``routerbench.run_algorithm``,
``run_closed_loop``), GreenCache's workload and drive
(``cache.make_workload``, ``cache.drive``), the scenario lab
(``scenarios``), the chaos drill (``chaos``) and disaggregated serving
under bursty traffic (``disagg``).  It mirrors the JAX package's
``benchmarks/common.py``, ``bench_baselines.py``, ``bench_routerbench.py``,
``bench_cache.py``, ``bench_scenarios.py``, ``bench_chaos.py`` and
``bench_disagg.py``, whose modules import the JAX package and so cannot
serve the port."""
