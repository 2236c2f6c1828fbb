"""Wire format for `serve`: npz request/response bodies.

Port of deepconsensus_tpu/serve/protocol.py, numpy only: the bodies
either package encodes are the same bytes, and a malformed body gets
the same typed rejection (class, message and HTTP status) from both.

One POST /v1/polish body carries one molecule's featurized windows
(the client runs preprocessing; the server owns triage + model +
stitch so serve output is byte-identical to the batch pipeline's).
npz keeps the bulk float32 tensors out of JSON and decodes with
allow_pickle=False, so a request body can never smuggle arbitrary
objects. Every field is validated against the loaded model's shapes
BEFORE the request is admitted — an oversized or malformed body is a
typed 4xx, not server memory growth (same posture as the PR-4 bounded
decoders).

Request arrays:
  subreads    float32 [n, total_rows, L, 1]
  window_pos  int64   [n]
  ccs_bq      int32   [n, L]   (draft CCS base qualities)
  overflow    uint8   [n]

where L must be one of the model's window length buckets
(params.window_buckets; max_length alone when bucketing is off). npz
arrays are rectangular, so one request carries one width; clients with
different window lengths share the server's per-bucket packs
concurrently.
  name        0-d str (molecule name)
  meta_json   0-d str (optional: ec / np_num_passes / rq / rg)

Response arrays (application/octet-stream):
  status      0-d str: ok | fallback | filtered | quarantined
  seq         uint8 [len]  (ascii bases; empty unless ok/fallback)
  quals       uint8 [len]  (phred values, not ascii)
  counters_json  0-d str   (per-request triage/window counters)
  error       0-d str      (quarantine detail; empty otherwise)

Versioned frames (fleet tier). A body with no `frame` field is the
legacy float32 request above — old clients keep working unchanged.
New bodies carry a 0-d `frame` string naming format+version:

  features/1  compact uint8 window pack (featurize tier -> model
              replica): every non-SN row of the float32 tensor holds
              clip-bounded integers (ccs_bq ships biased +1 so its -1
              pad sentinels survive the uint8 cast) and the 4 SN rows
              are per-window constants, so the bulk tensor ships as
              main_u8 uint8 [n, total_rows-4, L, 1] + sn float32
              [n, 4] (~4x fewer bytes) and reconstructs losslessly.
  bam/1       raw-BAM request (client -> featurize tier): whole
              mini-BAM file bytes for one molecule's subreads + draft
              CCS; a featurize worker runs decode/pileup on it.

A server that doesn't recognize a frame answers a typed 400 naming
the frames it speaks — version negotiation is an error message, not a
parse crash (an old server predating `frame` rejects a features/1
body with its ordinary missing-field 400 for the same reason).

Errors travel as application/json: {"error", "kind", "status"}.
"""
from __future__ import annotations

import io
import json
from typing import Any, Dict, Optional

import numpy as np

from deepconsensus_tpu_torch import faults as faults_lib

CONTENT_TYPE = 'application/octet-stream'
DEADLINE_HEADER = 'X-Dctpu-Deadline-S'
# Request/trace id minted at the outermost tier (router for fleet
# traffic) and carried across every hop so spans from router,
# featurize worker and replica join into one trace (obs.trace).
TRACE_HEADER = 'X-Dctpu-Trace-Id'
# Multi-tenant QoS (fleet tier). CLASS_HEADER names the priority class
# the request is admitted under ('interactive', 'bulk', ...; lowercase
# [a-z0-9_-], ≤32 chars — anything else is a typed 400). CLIENT_HEADER
# is the tenant id per-client quotas are charged against; absent, the
# router falls back to the peer address. Both are advisory to a bare
# replica (it serves FIFO) — the router is where weighted-fair
# admission happens.
CLASS_HEADER = 'X-Dctpu-Class'
CLIENT_HEADER = 'X-Dctpu-Client'
REQUEST_FIELDS = ('name', 'subreads', 'window_pos', 'ccs_bq', 'overflow')
_META_KEYS = ('ec', 'np_num_passes', 'rq', 'rg')

FRAME_FEATURES = 'features/1'
FRAME_BAM = 'bam/1'
# Frames a model replica's decode_request speaks (bam/1 is understood
# but redirected: it belongs to the featurize tier).
KNOWN_FRAMES = (FRAME_FEATURES, FRAME_BAM)
FEATURES_FIELDS = ('name', 'main_u8', 'sn', 'window_pos', 'ccs_bq',
                   'overflow')
BAM_FIELDS = ('name', 'subreads_bam', 'ccs_bam')
_SN_ROWS = 4  # trailing per-window SN constant rows (preprocess.pileup)


def _bq_row_for_total_rows(total_rows: int) -> Optional[int]:
  """ccs_bq row index within the non-SN block, derived from the row
  count alone: total_rows is 4*max_passes+5 without a ccs_bq row and
  4*max_passes+6 with one, so total_rows mod 4 (1 vs 2) disambiguates
  and both encode and decode agree without shipping layout metadata."""
  if total_rows % 4 == 2:
    max_passes = (total_rows - 6) // 4
    return 4 * max_passes + 1
  return None


def encode_request(name: str, subreads: np.ndarray,
                   window_pos: np.ndarray, ccs_bq: np.ndarray,
                   overflow: np.ndarray,
                   meta: Optional[Dict[str, Any]] = None) -> bytes:
  buf = io.BytesIO()
  np.savez(
      buf,
      name=np.array(str(name)),
      subreads=np.asarray(subreads, dtype=np.float32),
      window_pos=np.asarray(window_pos, dtype=np.int64),
      ccs_bq=np.asarray(ccs_bq, dtype=np.int32),
      overflow=np.asarray(overflow, dtype=np.uint8),
      meta_json=np.array(json.dumps(
          {k: meta[k] for k in _META_KEYS if meta and meta.get(k) is not None}
      )),
  )
  return buf.getvalue()


def request_from_features(features) -> bytes:
  """Builds a request body from one molecule's preprocess window
  feature dicts (runner.preprocess_zmw output)."""
  fd0 = features[0]
  name = fd0['name'] if isinstance(fd0['name'], str) else fd0['name'].decode()
  return encode_request(
      name=name,
      subreads=np.stack([fd['subreads'] for fd in features]),
      window_pos=np.array([fd['window_pos'] for fd in features]),
      ccs_bq=np.stack(
          [np.asarray(fd['ccs_base_quality_scores']) for fd in features]),
      overflow=np.array([bool(fd['overflow']) for fd in features]),
      meta={k: fd0.get(k) for k in _META_KEYS},
  )


def features_pack_from_features(features) -> Optional[bytes]:
  """Compact features/1 body from one molecule's preprocess window
  feature dicts, or None when the tensor is not losslessly uint8-
  packable (non-integral or out-of-range values, SN rows that are not
  per-window constants) — callers fall back to request_from_features,
  so packing is an optimization, never a correctness risk."""
  fd0 = features[0]
  name = fd0['name'] if isinstance(fd0['name'], str) else fd0['name'].decode()
  subreads = np.stack(
      [fd['subreads'] for fd in features]).astype(np.float32, copy=False)
  body = encode_features_pack(
      name=name,
      subreads=subreads,
      window_pos=np.array([fd['window_pos'] for fd in features]),
      ccs_bq=np.stack(
          [np.asarray(fd['ccs_base_quality_scores']) for fd in features]),
      overflow=np.array([bool(fd['overflow']) for fd in features]),
      meta={k: fd0.get(k) for k in _META_KEYS},
  )
  return body


def encode_features_pack(name: str, subreads: np.ndarray,
                         window_pos: np.ndarray, ccs_bq: np.ndarray,
                         overflow: np.ndarray,
                         meta: Optional[Dict[str, Any]] = None
                         ) -> Optional[bytes]:
  """Encodes the float32 window tensor as a features/1 compact pack,
  or returns None when the split would be lossy (see
  features_pack_from_features)."""
  subreads = np.asarray(subreads, dtype=np.float32)
  if subreads.ndim != 4 or subreads.shape[1] <= _SN_ROWS:
    return None
  sn_block = subreads[:, -_SN_ROWS:]
  if not (sn_block == sn_block[:, :, :1, :]).all():
    return None
  main = np.array(subreads[:, :-_SN_ROWS])
  bq_row = _bq_row_for_total_rows(subreads.shape[1])
  if bq_row is not None:
    main[:, bq_row] += 1.0
  if main.size and (main.min() < 0.0 or main.max() > 255.0):
    return None
  main_u8 = main.astype(np.uint8)
  if not np.array_equal(main_u8.astype(np.float32), main):
    return None  # non-integral values would round
  buf = io.BytesIO()
  np.savez(
      buf,
      frame=np.array(FRAME_FEATURES),
      name=np.array(str(name)),
      main_u8=main_u8,
      sn=np.ascontiguousarray(sn_block[:, :, 0, 0].astype(np.float32)),
      window_pos=np.asarray(window_pos, dtype=np.int64),
      ccs_bq=np.asarray(ccs_bq, dtype=np.int32),
      overflow=np.asarray(overflow, dtype=np.uint8),
      meta_json=np.array(json.dumps(
          {k: meta[k] for k in _META_KEYS if meta and meta.get(k) is not None}
      )),
  )
  return buf.getvalue()


def encode_bam_request(subreads_bam: bytes, ccs_bam: bytes,
                       name: str = '',
                       meta: Optional[Dict[str, Any]] = None) -> bytes:
  """bam/1 body: whole mini-BAM file bytes for one molecule (subreads
  aligned to the draft CCS, plus the draft CCS itself). The featurize
  tier owns decoding them with the hardened io.bam readers."""
  buf = io.BytesIO()
  np.savez(
      buf,
      frame=np.array(FRAME_BAM),
      name=np.array(str(name)),
      subreads_bam=np.frombuffer(subreads_bam, dtype=np.uint8),
      ccs_bam=np.frombuffer(ccs_bam, dtype=np.uint8),
      meta_json=np.array(json.dumps(
          {k: meta[k] for k in _META_KEYS if meta and meta.get(k) is not None}
      )),
  )
  return buf.getvalue()


def decode_bam_request(body: bytes) -> Dict[str, Any]:
  """Parses a bam/1 body (featurize-worker side). Size bounds are the
  HTTP layer's max_body_bytes; record-level bounds are the BAM
  reader's own max_record_bytes guard."""
  try:
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
      frame = str(z['frame']) if 'frame' in z.files else None
      if frame != FRAME_BAM:
        raise faults_lib.BadRequestError(
            f'featurize worker expects a {FRAME_BAM} frame, got '
            f'{frame or "a legacy polish request"}')
      missing = [f for f in BAM_FIELDS if f not in z.files]
      if missing:
        raise faults_lib.BadRequestError(
            f'{FRAME_BAM} request missing field(s): {missing}')
      name = str(z['name'])
      subreads_bam = z['subreads_bam']
      ccs_bam = z['ccs_bam']
      meta = json.loads(str(z['meta_json'])) if 'meta_json' in z.files else {}
  except faults_lib.BadRequestError:
    raise
  except Exception as e:
    raise faults_lib.BadRequestError(
        f'undecodable request body: {type(e).__name__}: {e}') from e
  if subreads_bam.dtype != np.uint8 or ccs_bam.dtype != np.uint8:
    raise faults_lib.BadRequestError('subreads_bam/ccs_bam must be uint8')
  if subreads_bam.size == 0 or ccs_bam.size == 0:
    raise faults_lib.BadRequestError('empty BAM payload')
  if not isinstance(meta, dict):
    raise faults_lib.BadRequestError('meta_json must encode an object')
  return {
      'name': name,
      'subreads_bam': subreads_bam.tobytes(),
      'ccs_bam': ccs_bam.tobytes(),
      'meta': meta,
  }


def sniff_frame(body: bytes) -> Optional[str]:
  """Reads just the frame tag of a request body (None = legacy float32
  request) without touching the bulk arrays — the router's steering
  decision. Undecodable bodies are a typed 400 here, before any bytes
  are forwarded to a replica."""
  try:
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
      if 'frame' not in z.files:
        return None
      return str(z['frame'])
  except Exception as e:
    raise faults_lib.BadRequestError(
        f'undecodable request body: {type(e).__name__}: {e}') from e


def decode_request(body: bytes, *, total_rows: int, max_length: int,
                   max_windows: int,
                   window_buckets=None) -> Dict[str, Any]:
  """Parses + validates one request body. Raises BadRequestError (400)
  on anything malformed and RequestTooLargeError (413) when the window
  count exceeds the admission cap. window_buckets: allowed window
  lengths (defaults to (max_length,))."""
  allowed = tuple(window_buckets) if window_buckets else (max_length,)
  try:
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
      frame = str(z['frame']) if 'frame' in z.files else None
      if frame == FRAME_BAM:
        raise faults_lib.BadRequestError(
            f'{FRAME_BAM} carries raw BAM bytes; POST it to a dctpu '
            'route front tier or a featurize worker, not to a model '
            'replica')
      if frame is not None and frame != FRAME_FEATURES:
        raise faults_lib.BadRequestError(
            f'unsupported request frame {frame!r}; this server '
            f'speaks the legacy float32 request and {KNOWN_FRAMES}')
      if frame == FRAME_FEATURES:
        missing = [f for f in FEATURES_FIELDS if f not in z.files]
        if missing:
          raise faults_lib.BadRequestError(
              f'{FRAME_FEATURES} request missing field(s): {missing}')
        name = str(z['name'])
        main_u8 = z['main_u8']
        sn = z['sn']
        if main_u8.dtype != np.uint8 or main_u8.ndim != 4:
          raise faults_lib.BadRequestError(
              f'main_u8 must be uint8 [n, rows, L, 1], got '
              f'{main_u8.dtype} {main_u8.shape}')
        if (sn.ndim != 2 or sn.shape != (main_u8.shape[0], _SN_ROWS)
            or not np.issubdtype(sn.dtype, np.floating)):
          raise faults_lib.BadRequestError(
              f'sn must be float [n, {_SN_ROWS}], got {sn.dtype} '
              f'{sn.shape}')
        # Lossless inverse of encode_features_pack: uint8 -> f32, undo
        # the ccs_bq +1 bias, re-broadcast the per-window SN scalars.
        main = main_u8.astype(np.float32)
        bq_row = _bq_row_for_total_rows(main_u8.shape[1] + _SN_ROWS)
        if bq_row is not None:
          main[:, bq_row] -= 1.0
        n_w, _, width_w, _ = main_u8.shape
        subreads = np.concatenate(
            [main,
             np.broadcast_to(
                 np.asarray(sn, dtype=np.float32)[:, :, None, None],
                 (n_w, _SN_ROWS, width_w, 1))],
            axis=1)
      else:
        missing = [f for f in REQUEST_FIELDS if f not in z.files]
        if missing:
          raise faults_lib.BadRequestError(
              f'request missing field(s): {missing}')
        name = str(z['name'])
        subreads = z['subreads']
      window_pos = z['window_pos']
      ccs_bq = z['ccs_bq']
      overflow = z['overflow']
      meta = json.loads(str(z['meta_json'])) if 'meta_json' in z.files else {}
  except faults_lib.BadRequestError:
    raise
  except Exception as e:  # zip/npz framing, bad JSON, disallowed pickle
    raise faults_lib.BadRequestError(
        f'undecodable request body: {type(e).__name__}: {e}') from e
  n = len(subreads)
  if n < 1:
    raise faults_lib.BadRequestError('request carries zero windows')
  if n > max_windows:
    raise faults_lib.RequestTooLargeError(
        f'{n} windows exceeds max_windows_per_request={max_windows}')
  if (subreads.ndim != 4 or subreads.shape[1] != total_rows
      or subreads.shape[2] not in allowed or subreads.shape[3] != 1):
    raise faults_lib.BadRequestError(
        f'subreads shape {subreads.shape} does not match the loaded '
        f'model: expected [n, {total_rows}, L, 1] with window length '
        f'L in {list(allowed)}')
  width = int(subreads.shape[2])
  if window_pos.shape != (n,) or overflow.shape != (n,):
    raise faults_lib.BadRequestError(
        'window_pos/overflow must be [n] aligned with subreads')
  if ccs_bq.shape != (n, width):
    raise faults_lib.BadRequestError(
        f'ccs_bq shape {ccs_bq.shape} != [n, {width}]')
  if not np.isfinite(subreads).all():
    raise faults_lib.BadRequestError('subreads contains non-finite values')
  if not isinstance(meta, dict):
    raise faults_lib.BadRequestError('meta_json must encode an object')
  return {
      'name': name,
      'subreads': subreads.astype(np.float32, copy=False),
      'window_pos': window_pos.astype(np.int64, copy=False),
      'ccs_bq': ccs_bq.astype(np.int32, copy=False),
      'overflow': overflow.astype(bool, copy=False),
      'meta': tuple(meta.get(k) for k in _META_KEYS),
  }


def encode_response(status: str, seq: bytes = b'',
                    quals: Optional[np.ndarray] = None,
                    counters: Optional[Dict[str, Any]] = None,
                    error: str = '') -> bytes:
  buf = io.BytesIO()
  np.savez(
      buf,
      status=np.array(status),
      seq=np.frombuffer(seq, dtype=np.uint8),
      quals=(np.asarray(quals, dtype=np.uint8) if quals is not None
             else np.zeros(0, dtype=np.uint8)),
      counters_json=np.array(json.dumps(counters or {})),
      error=np.array(error[:4000]),
  )
  return buf.getvalue()


def decode_response(body: bytes) -> Dict[str, Any]:
  with np.load(io.BytesIO(body), allow_pickle=False) as z:
    return {
        'status': str(z['status']),
        'seq': z['seq'].tobytes(),
        'quals': np.array(z['quals']),
        'counters': json.loads(str(z['counters_json'])),
        'error': str(z['error']),
    }
