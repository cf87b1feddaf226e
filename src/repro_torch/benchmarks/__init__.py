"""The paper-scale harness of the port: the offline replay of the paper's
experiments (``common.run_policy``), the paced ``PoolServer`` drive over
``SimEngine``s (``common.drive_pool_stream``), the baselines table
(``baselines.run``) and the RouterBench scorecard
(``routerbench.run_algorithm``).  It mirrors the JAX package's
``benchmarks/common.py``, ``bench_baselines.py`` and
``bench_routerbench.py``, whose modules import the JAX package and so
cannot serve the port."""
