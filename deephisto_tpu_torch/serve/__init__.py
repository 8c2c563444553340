"""Online serving for trained patch classifiers, a port of
``deephisto_tpu/serve``: a long-lived engine that loads a checkpoint once,
keeps the model on the card across requests and stages slides there, and a
dependency-free HTTP daemon in front of it.

    python -m deephisto_tpu_torch.serve --config cfg.yaml --weights best.msgpack \\
        --int8 --port 8477

Routes: ``server.py``.
"""

from .engine import ServingEngine
from .server import make_server, serve_forever, serve_in_thread

__all__ = ["ServingEngine", "make_server", "serve_forever", "serve_in_thread"]
