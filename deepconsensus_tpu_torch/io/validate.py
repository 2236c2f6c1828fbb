"""Preflight input validation: `cli validate`.

Port of deepconsensus_tpu/io/validate.py on the port's hardened
decoders (io/bam.py with the native BGZF inflate, io/tfrecord.py).
Streams an actc/ccs BAM pair or a TFRecord glob end to end and reports,
per file: header sanity, per-record parse health, ZMW grouping order,
the BGZF EOF marker, and actc <-> ccs name consistency, as a report
dict (the CLI prints it as JSON and exits 1 when a check fails), so a
truncated upload or a bit-rotted shard is caught before a card spends
time on it.

Every error entry carries `file` and `offset` (and `zmw` when known).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from deepconsensus_tpu_torch.faults import CorruptInputError
from deepconsensus_tpu_torch.io import bam as bam_lib
from deepconsensus_tpu_torch.io import tfrecord as tfrecord_lib
from deepconsensus_tpu_torch.io.bam_writer import BGZF_EOF

# Per-file cap on enumerated record errors: corruption tends to cascade
# (one flipped length desynchronizes everything after it), so reports
# stay useful and bounded.
DEFAULT_MAX_ERRORS = 20


def _error_entry(e: Exception, path: str) -> Dict[str, Any]:
  return {
      'file': getattr(e, 'path', None) or path,
      'offset': getattr(e, 'offset', None),
      'zmw': getattr(e, 'zmw', None),
      'recoverable': bool(getattr(e, 'recoverable', False)),
      'error': str(e),
  }


def check_bgzf_eof(path: str) -> bool:
  """True when the file ends with the 28-byte BGZF EOF marker.

  Its absence is the classic signature of a truncated upload: writers
  (htslib, BgzfWriter here) append it at close, so a file missing it
  almost certainly lost its tail."""
  try:
    size = os.path.getsize(path)
    if size < len(BGZF_EOF):
      return False
    with open(path, 'rb') as f:
      f.seek(size - len(BGZF_EOF))
      return f.read(len(BGZF_EOF)) == BGZF_EOF
  except OSError:
    return False


def validate_bam(path: str,
                 max_record_bytes: int = bam_lib.DEFAULT_MAX_RECORD_BYTES,
                 max_errors: int = DEFAULT_MAX_ERRORS,
                 collect_names: Optional[str] = None) -> Dict[str, Any]:
  """Streams every record of one BAM through the hardened decoder.

  Recoverable (record-local) errors are enumerated up to max_errors and
  scanning continues; a stream-level error (truncation, BGZF damage)
  ends the scan. Also verifies `zm`-tag grouping: a ZMW that reappears
  after a different ZMW interleaved means the file is not actc-grouped
  and SubreadGrouper would silently split the molecule.

  collect_names='reference' records the run-length-deduplicated order
  of reference names (the ccs read each actc subread aligns to);
  'qname' records read-name order (the ccs BAM side). Used by the
  pair-consistency check."""
  report: Dict[str, Any] = {
      'path': path,
      'format': 'bam',
      'ok': False,
      'bgzf_eof': check_bgzf_eof(path),
      'n_records': 0,
      'n_corrupt_records': 0,
      'zmw_ordering_ok': True,
      'errors': [],
  }
  names: List[str] = []
  try:
    reader = bam_lib.BamReader(path, max_record_bytes=max_record_bytes)
  except CorruptInputError as e:
    report['errors'].append(_error_entry(e, path))
    return report
  report['header_ok'] = True
  report['n_references'] = len(reader.references)
  seen_zmws = set()
  last_zmw: Optional[int] = None
  with reader:
    while True:
      try:
        record = next(reader)
      except StopIteration:
        break
      except CorruptInputError as e:
        report['n_corrupt_records'] += 1
        if len(report['errors']) < max_errors:
          report['errors'].append(_error_entry(e, path))
        if not e.recoverable:
          return report
        continue
      report['n_records'] += 1
      if collect_names:
        name = (record.qname if collect_names == 'qname'
                else record.reference_name)
        if name is not None and (not names or names[-1] != name):
          names.append(name)
      zmw = record.tags.get('zm')
      if zmw is not None and isinstance(zmw, (int,)) and zmw != last_zmw:
        if zmw in seen_zmws:
          report['zmw_ordering_ok'] = False
          if len(report['errors']) < max_errors:
            report['errors'].append({
                'file': path,
                'offset': None,
                'zmw': str(zmw),
                'recoverable': True,
                'error': f'ZMW {zmw} reappears after other ZMWs '
                         '(input is not grouped by zm tag)',
            })
        seen_zmws.add(zmw)
        last_zmw = zmw
  if not report['bgzf_eof']:
    report['errors'].append({
        'file': path,
        'offset': max(os.path.getsize(path) - len(BGZF_EOF), 0),
        'zmw': None,
        'recoverable': False,
        'error': 'missing BGZF EOF marker (file tail truncated?)',
    })
  report['ok'] = (report['n_corrupt_records'] == 0
                  and report['zmw_ordering_ok'] and report['bgzf_eof']
                  and not report['errors'])
  if collect_names:
    report['_names'] = names
  return report


def validate_tfrecord(path: str,
                      max_record_bytes: int = (
                          tfrecord_lib.DEFAULT_MAX_RECORD_BYTES),
                      max_errors: int = DEFAULT_MAX_ERRORS) -> Dict[str, Any]:
  """Streams one TFRecord shard with full CRC checking.

  TFRecord framing has no resync point — once a frame is corrupt every
  later offset is untrusted — so the scan stops at the first error."""
  report: Dict[str, Any] = {
      'path': path,
      'format': 'tfrecord',
      'ok': False,
      'n_records': 0,
      'errors': [],
  }
  if path.endswith('.gz'):
    report['bgzf_eof'] = check_bgzf_eof(path)
  try:
    with tfrecord_lib.TFRecordReader(
        path, check_crc=True, max_record_bytes=max_record_bytes) as reader:
      for _ in reader:
        report['n_records'] += 1
  except CorruptInputError as e:
    report['errors'].append(_error_entry(e, path))
    return report
  except OSError as e:
    report['errors'].append({
        'file': path, 'offset': None, 'zmw': None, 'recoverable': False,
        'error': f'{type(e).__name__}: {e}',
    })
    return report
  # bgzf_eof stays informational for .gz shards (only BGZF writers emit
  # the marker); the CRC-checked scan above is the authoritative verdict.
  report['ok'] = True
  return report


def validate_actc_ccs_pair(subreads_report: Dict[str, Any],
                           ccs_report: Dict[str, Any]) -> Dict[str, Any]:
  """Cross-checks actc subread alignments against the ccs BAM.

  Every reference (= ccs read) the subreads align to must exist in the
  ccs BAM, and the actc group order must follow the ccs read order —
  the preprocess feeder walks both files in lockstep and desynchronizes
  otherwise."""
  result: Dict[str, Any] = {'checked': True, 'ok': True, 'errors': []}
  actc_names = subreads_report.pop('_names', None)
  ccs_names = ccs_report.pop('_names', None)
  if actc_names is None or ccs_names is None:
    result['checked'] = False
    return result
  ccs_order = {name: i for i, name in enumerate(ccs_names)}
  prev_idx = -1
  seen = set()
  for name in actc_names:
    if name in seen:
      result['ok'] = False
      result['errors'].append({
          'file': subreads_report['path'], 'offset': None, 'zmw': name,
          'recoverable': False,
          'error': f'subread group for {name!r} is split (reappears '
                   'after other groups)',
      })
      continue
    seen.add(name)
    idx = ccs_order.get(name)
    if idx is None:
      result['ok'] = False
      result['errors'].append({
          'file': subreads_report['path'], 'offset': None, 'zmw': name,
          'recoverable': False,
          'error': f'subreads align to {name!r} which is absent from '
                   'the ccs BAM',
      })
      continue
    if idx < prev_idx:
      result['ok'] = False
      result['errors'].append({
          'file': subreads_report['path'], 'offset': None, 'zmw': name,
          'recoverable': False,
          'error': f'subread group {name!r} is out of order relative '
                   'to the ccs BAM (lockstep scan would desync)',
      })
      continue
    prev_idx = idx
  return result


def validate_inputs(subreads_to_ccs: Optional[str] = None,
                    ccs_bam: Optional[str] = None,
                    tfrecords: Optional[List[str]] = None,
                    max_record_bytes: Optional[int] = None,
                    max_errors: int = DEFAULT_MAX_ERRORS) -> Dict[str, Any]:
  """Runs every applicable check; returns the full report dict.

  report['ok'] is the single pass/fail verdict the CLI turns into an
  exit code."""
  report: Dict[str, Any] = {'ok': True, 'files': [], 'n_errors': 0}
  bam_cap = (max_record_bytes if max_record_bytes is not None
             else bam_lib.DEFAULT_MAX_RECORD_BYTES)
  tfr_cap = (max_record_bytes if max_record_bytes is not None
             else tfrecord_lib.DEFAULT_MAX_RECORD_BYTES)
  pair = subreads_to_ccs is not None and ccs_bam is not None
  subreads_report = None
  ccs_report = None
  if subreads_to_ccs is not None:
    subreads_report = validate_bam(
        subreads_to_ccs, max_record_bytes=bam_cap, max_errors=max_errors,
        collect_names='reference' if pair else None)
    report['files'].append(subreads_report)
  if ccs_bam is not None:
    ccs_report = validate_bam(
        ccs_bam, max_record_bytes=bam_cap, max_errors=max_errors,
        collect_names='qname' if pair else None)
    report['files'].append(ccs_report)
  if pair:
    report['pair'] = validate_actc_ccs_pair(subreads_report, ccs_report)
    if not report['pair']['ok']:
      report['ok'] = False
      report['n_errors'] += len(report['pair']['errors'])
  for path in tfrecord_lib.glob_paths(tfrecords or []):
    report['files'].append(
        validate_tfrecord(path, max_record_bytes=tfr_cap,
                          max_errors=max_errors))
  for entry in report['files']:
    entry.pop('_names', None)
    if not entry['ok']:
      report['ok'] = False
    report['n_errors'] += len(entry['errors'])
  return report
