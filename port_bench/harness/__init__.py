"""The benchmark harness of the PyTorch + CUDA port (``ctr_recommendation_tpu_torch``).

Only ``program`` imports the port; the rest of the harness, the traffic
kinds' data, the yardstick (``yardstick``) and the plain reference
(``port_bench/reference``) import neither the port nor JAX.
"""
