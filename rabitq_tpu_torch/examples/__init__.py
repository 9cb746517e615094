"""The port's twins of the repo's examples/: each follows its JAX example
step for step on the port's API, runs on the card by default and takes
``--device cpu``:

    python -m rabitq_tpu_torch.examples.quickstart
    python -m rabitq_tpu_torch.examples.mutations
    python -m rabitq_tpu_torch.examples.disk_tier
    python -m rabitq_tpu_torch.examples.distributed [--shards S]

Each module's ``main(argv)`` returns what it computed, for the tests.
"""
