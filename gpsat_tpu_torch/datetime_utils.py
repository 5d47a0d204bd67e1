"""Satellite-file datetime parsing helpers (copy of
gpsat_tpu/datetime_utils.py; reference: GPSat/datetime_utils.py:11-274)."""

import re
from datetime import datetime

import numpy as np

__all__ = ["from_file_start_end_datetime_GPOD", "from_file_start_end_datetime",
           "datetime_from_float_column", "from_file_datetime_SARAL"]


def from_file_start_end_datetime_GPOD(fn, get="start"):
    """Parse start/end datetimes from GPOD-style filenames containing
    _YYYYMMDDTHHMMSS_..._YYYYMMDDTHHMMSS_ segments
    (reference: datetime_utils.py:11)."""
    stamps = re.findall(r"(\d{8}T\d{6})", str(fn))
    assert len(stamps) >= 2, f"could not find two datetime stamps in: {fn}"
    fmt = "%Y%m%dT%H%M%S"
    start = datetime.strptime(stamps[0], fmt)
    end = datetime.strptime(stamps[1], fmt)
    if get == "start":
        return start
    if get == "end":
        return end
    return start, end


def from_file_datetime_SARAL(fn, get="start"):
    """SARAL filenames carry _YYYYMMDD_HHMMSS_ pairs
    (reference: datetime_utils.py)."""
    stamps = re.findall(r"(\d{8}_\d{6})", str(fn))
    assert stamps, f"could not find datetime stamps in: {fn}"
    fmt = "%Y%m%d_%H%M%S"
    parsed = [datetime.strptime(s, fmt) for s in stamps]
    if get == "start":
        return parsed[0]
    if get == "end":
        return parsed[-1]
    return parsed[0], parsed[-1]


def from_file_start_end_datetime(fn, get="start", regex=r"(\d{8}T\d{6})",
                                 fmt="%Y%m%dT%H%M%S"):
    """Generic filename datetime extraction."""
    stamps = re.findall(regex, str(fn))
    assert stamps, f"no datetime stamps matching {regex!r} in: {fn}"
    parsed = [datetime.strptime(s, fmt) for s in stamps]
    return parsed[0] if get == "start" else parsed[-1]


def datetime_from_float_column(vals, epoch="1950-01-01", unit="D"):
    """Float offsets from an epoch -> datetime64 array
    (reference: datetime_utils.py:143)."""
    vals = np.asarray(vals, dtype=float)
    epoch64 = np.datetime64(epoch)
    if unit == "D":
        delta = (vals * 86400.0 * 1e9).astype("timedelta64[ns]")
    elif unit == "s":
        delta = (vals * 1e9).astype("timedelta64[ns]")
    else:
        raise ValueError(f"unit: {unit} not in ('D', 's')")
    return epoch64.astype("datetime64[ns]") + delta
