"""The repo's tools on the port: the bench suite, the scaling bench, the
ingest drill and the accuracy-parity harness (counterparts of tools/).
Each is ``python -m euler_tpu_torch.tools.<name>``, runs on the card
unless ``--device cpu`` is given, and writes its record under
``build/euler_tpu_torch/`` (``_build.BUILD_DIR``), never over the TPU
records at the root."""
