"""`serve`: a resident consensus service on the ConsensusEngine (port
of deepconsensus_tpu/serve).

* protocol.py — the npz-over-HTTP wire format, with byte and window
  caps enforced before any allocation is trusted.
* service.py  — ConsensusService: admission control, one model loop
  that owns the card and batches windows across concurrent requests,
  per-request deadlines, pack-failure isolation retries and
  per-request quarantine with dead-letter attribution.
* server.py   — the standard library's ThreadingHTTPServer front end
  (/v1/polish, /healthz, /readyz, /metricz, /debugz/profile) and
  serve_main with its SIGTERM drain.
* client.py   — ServeClient and the raw-socket fault senders.

The re-exports below resolve lazily (PEP 562): service.py pulls in
torch through the engine, while protocol, server and client need only
numpy and the standard library, so the featurize workers and routers
that import them stay light.
"""

_SERVICE_EXPORTS = ('ConsensusService', 'ServeOptions')

__all__ = list(_SERVICE_EXPORTS)


def __getattr__(name):
  if name in _SERVICE_EXPORTS:
    from deepconsensus_tpu_torch.serve import service

    return getattr(service, name)
  # PEP 562's module __getattr__ must raise AttributeError.
  raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
