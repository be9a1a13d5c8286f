"""HTTP serving layer of the port."""

from go_pocket_tts_tpu_torch.server.http import Server, make_handler, probe_http

__all__ = ["Server", "make_handler", "probe_http"]
