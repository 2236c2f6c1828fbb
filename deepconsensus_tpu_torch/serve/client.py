"""ServeClient: the thin client side of `serve`.

Port of deepconsensus_tpu/serve/client.py (numpy and the standard
library only). polish() ships one molecule's featurized windows and
returns the polished read; stitch.format_fastq_bytes turns it into the
FASTQ record a batch `run` writes for the same molecule.

Also home to the raw-socket fault senders (mid-request disconnect,
garbage body, oversized body, slowloris), and the env-hook sabotage:
with DCTPU_FAULT_SERVE_CLIENT set, polish() misbehaves on the wire
instead of sending its request, so an otherwise correct client becomes
the adversarial client of a fault drill.
"""
from __future__ import annotations

import http.client
import json
import os
import socket
import time
from typing import Any, Dict, Optional

import numpy as np

from deepconsensus_tpu_torch import faults as shared_faults
from deepconsensus_tpu_torch.serve import protocol

CLIENT_FAULT_MODES = ('disconnect', 'garbage', 'oversized', 'slowloris')


class ServeClientError(RuntimeError):
  """A non-200 response, with the server's typed error attached."""

  def __init__(self, status: int, payload: Dict[str, Any]):
    super().__init__(
        f'HTTP {status}: {payload.get("error", "<no error body>")}')
    self.status = status
    self.kind = payload.get('kind', shared_faults.FaultKind.PERMANENT)
    self.payload = payload


class ServeClient:
  """One connection-per-call HTTP client (stdlib http.client)."""

  def __init__(self, host: str = '127.0.0.1', port: int = 8764,
               timeout: float = 180.0, klass: Optional[str] = None,
               client: Optional[str] = None):
    self.host = host
    self.port = port
    self.timeout = timeout
    # Multi-tenant QoS identity, sent as headers on every polish: the
    # router charges admission to (class, client). Unset = the
    # router's defaults (interactive class, peer-address client).
    self.klass = klass
    self.client = client

  def _request(self, method: str, path: str, body: bytes = b'',
               headers: Optional[Dict[str, str]] = None):
    conn = http.client.HTTPConnection(
        self.host, self.port, timeout=self.timeout)
    try:
      conn.request(method, path, body=body, headers=headers or {})
      resp = conn.getresponse()
      return resp.status, resp.read(), resp.getheader('Content-Type', '')
    finally:
      conn.close()

  def _polish_headers(self, deadline_s: Optional[float],
                      trace_id: Optional[str]) -> Dict[str, str]:
    headers = {'Content-Type': protocol.CONTENT_TYPE}
    if deadline_s is not None:
      headers[protocol.DEADLINE_HEADER] = str(deadline_s)
    if trace_id:
      headers[protocol.TRACE_HEADER] = trace_id
    if self.klass:
      headers[protocol.CLASS_HEADER] = self.klass
    if self.client:
      headers[protocol.CLIENT_HEADER] = self.client
    return headers

  def _get_json(self, path: str) -> Dict[str, Any]:
    status, body, _ = self._request('GET', path)
    out = json.loads(body)
    out['_status'] = status
    return out

  def healthz(self) -> Dict[str, Any]:
    return self._get_json('/healthz')

  def readyz(self) -> Dict[str, Any]:
    return self._get_json('/readyz')

  def metricz(self) -> Dict[str, Any]:
    return self._get_json('/metricz')

  def wait_ready(self, timeout: float = 120.0,
                 interval: float = 0.2) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
      try:
        if self.readyz().get('ready'):
          return True
      except (ConnectionError, socket.timeout, TimeoutError, OSError):
        pass
      time.sleep(interval)
    return False

  def polish(self, name: str, subreads: np.ndarray,
             window_pos: np.ndarray, ccs_bq: np.ndarray,
             overflow: np.ndarray,
             meta: Optional[Dict[str, Any]] = None,
             deadline_s: Optional[float] = None,
             trace_id: Optional[str] = None) -> Dict[str, Any]:
    """Polishes one molecule. Returns the decoded response dict
    (status/seq/quals/counters/error); raises ServeClientError on a
    typed rejection. Honors the DCTPU_FAULT_SERVE_CLIENT sabotage
    hooks (see maybe_sabotage)."""
    body = protocol.encode_request(
        name, subreads, window_pos, ccs_bq, overflow, meta)
    sabotaged = maybe_sabotage(self.host, self.port, name, body)
    if sabotaged:
      return {'status': 'client-fault', 'mode': sabotaged,
              'seq': b'', 'quals': None}
    status, resp_body, ctype = self._request(
        'POST', '/v1/polish', body=body,
        headers=self._polish_headers(deadline_s, trace_id))
    if status != 200:
      try:
        payload = json.loads(resp_body)
      except (ValueError, UnicodeDecodeError):
        payload = {'error': resp_body[:200].decode('latin-1')}
      raise ServeClientError(status, payload)
    del ctype
    return protocol.decode_response(resp_body)

  def polish_features(self, features, deadline_s: Optional[float] = None,
                      compact: bool = False,
                      trace_id: Optional[str] = None) -> Dict[str, Any]:
    """polish() from preprocess window feature dicts. compact=True
    ships a features/1 uint8 pack (~4x fewer wire bytes) when the
    tensor packs losslessly, silently falling back to the legacy
    float32 frame when it doesn't — the server reconstructs the exact
    same tensor either way."""
    body = None
    if compact:
      body = protocol.features_pack_from_features(features)
    if body is None:
      body = protocol.request_from_features(features)
    fd0 = features[0]
    name = (fd0['name'] if isinstance(fd0['name'], str)
            else fd0['name'].decode())
    return self.polish_body(body, name=name, deadline_s=deadline_s,
                            trace_id=trace_id)

  def polish_body(self, body: bytes, name: str = '',
                  deadline_s: Optional[float] = None,
                  trace_id: Optional[str] = None) -> Dict[str, Any]:
    """POSTs an already-encoded /v1/polish body (legacy, features/1,
    or, against a router, bam/1). The featurize tier reuses this to
    ship packs without encoding them again."""
    sabotaged = maybe_sabotage(self.host, self.port, name, body)
    if sabotaged:
      return {'status': 'client-fault', 'mode': sabotaged,
              'seq': b'', 'quals': None}
    status, resp_body, _ = self._request(
        'POST', '/v1/polish', body=body,
        headers=self._polish_headers(deadline_s, trace_id))
    if status != 200:
      try:
        payload = json.loads(resp_body)
      except (ValueError, UnicodeDecodeError):
        payload = {'error': resp_body[:200].decode('latin-1')}
      raise ServeClientError(status, payload)
    return protocol.decode_response(resp_body)

  def polish_bam(self, subreads_bam: bytes, ccs_bam: bytes,
                 name: str = '',
                 deadline_s: Optional[float] = None,
                 trace_id: Optional[str] = None) -> Dict[str, Any]:
    """polish() from one molecule's raw mini-BAM bytes, for use
    against a `route` front tier with a featurize tier behind
    it (a bare model replica answers a typed 400)."""
    body = protocol.encode_bam_request(subreads_bam, ccs_bam, name=name)
    return self.polish_body(body, name=name, deadline_s=deadline_s,
                            trace_id=trace_id)


# ----------------------------------------------------------------------
# Adversarial senders (fault drills against a live server)


def _connect(host: str, port: int, timeout: float = 30.0) -> socket.socket:
  return socket.create_connection((host, port), timeout=timeout)


def send_disconnect(host: str, port: int, body: bytes) -> int:
  """Mid-request disconnect: claims the full body length, sends half,
  slams the connection. Returns bytes actually sent."""
  half = body[: max(1, len(body) // 2)]
  with _connect(host, port) as sock:
    sock.sendall(
        b'POST /v1/polish HTTP/1.1\r\n'
        b'Host: x\r\n'
        b'Content-Type: application/octet-stream\r\n'
        + f'Content-Length: {len(body)}\r\n\r\n'.encode()
    )
    sock.sendall(half)
    # RST rather than FIN where possible, the rudest disconnect.
    sock.setsockopt(
        socket.SOL_SOCKET, socket.SO_LINGER,
        __import__('struct').pack('ii', 1, 0))
  return len(half)


def send_garbage(host: str, port: int, n_bytes: int = 4096,
                 seed: int = 0) -> int:
  """Well-framed HTTP carrying a body that is not an npz at all.
  Returns the HTTP status (expected: 400)."""
  rng = np.random.default_rng(seed)
  body = rng.integers(0, 256, size=n_bytes, dtype=np.uint8).tobytes()
  conn = http.client.HTTPConnection(host, port, timeout=30)
  try:
    conn.request('POST', '/v1/polish', body=body,
                 headers={'Content-Type': protocol.CONTENT_TYPE})
    return conn.getresponse().status
  finally:
    conn.close()


def send_oversized(host: str, port: int,
                   claimed_bytes: int = 1 << 40) -> int:
  """Claims an absurd Content-Length with no body behind it. The
  server must reject on the header alone (413) without allocating.
  Returns the HTTP status."""
  with _connect(host, port) as sock:
    sock.sendall(
        b'POST /v1/polish HTTP/1.1\r\n'
        b'Host: x\r\n'
        + f'Content-Length: {claimed_bytes}\r\n\r\n'.encode())
    data = sock.recv(64)
  try:
    return int(data.split(b' ')[1])
  except (IndexError, ValueError):
    return -1


def send_slowloris(host: str, port: int, duration_s: float = 60.0,
                   interval_s: float = 1.0) -> float:
  """Drips one header byte per interval. A hardened server cuts the
  socket at io_timeout_s; returns how long the connection survived."""
  t0 = time.monotonic()
  payload = b'POST /v1/polish HTTP/1.1\r\nHost: x\r\nX-Drip: '
  try:
    with _connect(host, port, timeout=interval_s * 2 + 5) as sock:
      for i in range(int(duration_s / interval_s)):
        sock.sendall(payload[i:i + 1] if i < len(payload) else b'a')
        time.sleep(interval_s)
        # A closed peer surfaces as ECONNRESET/EPIPE on the next send.
  except OSError:
    pass
  return time.monotonic() - t0


def maybe_sabotage(host: str, port: int, name: str,
                   body: bytes) -> Optional[str]:
  """Env-hook self-sabotage: when DCTPU_FAULT_SERVE_CLIENT names a
  fault mode (and DCTPU_FAULT_SERVE_CLIENT_ZMW, if set, is a substring
  of this molecule's name), misbehave on the wire instead of sending
  the request. Returns the mode fired, or None."""
  mode = os.environ.get(shared_faults.ENV_SERVE_CLIENT_FAULT)
  if not mode:
    return None
  scope = os.environ.get(shared_faults.ENV_SERVE_CLIENT_FAULT_ZMW)
  if scope and scope not in name:
    return None
  if mode not in CLIENT_FAULT_MODES:
    # dclint: allow=typed-faults (fault-injection env validation: a
    # typo in the harness knob should abort the test loudly)
    raise ValueError(
        f'{shared_faults.ENV_SERVE_CLIENT_FAULT}={mode!r}: must be one '
        f'of {CLIENT_FAULT_MODES}')
  if mode == 'disconnect':
    send_disconnect(host, port, body)
  elif mode == 'garbage':
    send_garbage(host, port, n_bytes=min(len(body), 65536) or 4096)
  elif mode == 'oversized':
    send_oversized(host, port)
  elif mode == 'slowloris':
    send_slowloris(host, port, duration_s=30.0, interval_s=0.5)
  return mode
