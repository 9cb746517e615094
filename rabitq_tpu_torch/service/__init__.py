"""The HTTP query service (port of rabitq_tpu.service): the micro-batching
server (``rabitq_tpu_torch.service.server``: BatchingEngine, make_handler,
serve, ``python -m rabitq_tpu_torch.service.server``) and its benchmark
client (``rabitq_tpu_torch.service.client``). Nothing is imported here,
so ``python -m`` runs the server module once."""
