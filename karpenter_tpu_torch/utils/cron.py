"""Minimal cron-schedule evaluation for disruption budget windows.

Supports standard 5-field cron (minute hour day-of-month month day-of-week)
plus the @hourly/@daily/@midnight/@weekly/@monthly/@yearly aliases — the
subset the reference accepts for NodePool budgets (nodepool.go:99-106,
upstream cronjob syntax, UTC, no timezones).
"""

from __future__ import annotations

from datetime import datetime, timedelta, timezone
from typing import Optional

_ALIASES = {
    "@hourly": "0 * * * *",
    "@daily": "0 0 * * *",
    "@midnight": "0 0 * * *",
    "@weekly": "0 0 * * 0",
    "@monthly": "0 0 1 * *",
    "@yearly": "0 0 1 1 *",
    "@annually": "0 0 1 1 *",
}

_RANGES = [(0, 59), (0, 23), (1, 31), (1, 12), (0, 6)]

_MONTH_NAMES = {
    name: i + 1
    for i, name in enumerate(
        ["jan", "feb", "mar", "apr", "may", "jun", "jul", "aug", "sep", "oct", "nov", "dec"]
    )
}
_DOW_NAMES = {name: i for i, name in enumerate(["sun", "mon", "tue", "wed", "thu", "fri", "sat"])}


class CronError(ValueError):
    pass


def _parse_field(field: str, lo: int, hi: int, names: dict[str, int]) -> tuple[set[int], bool]:
    """Returns (allowed values, is_wildcard)."""
    out: set[int] = set()
    wildcard = False
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
            if step <= 0:
                raise CronError(f"invalid step in {field!r}")
        if part in ("*", "?"):
            wildcard = wildcard or step == 1
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            start, end = _value(a, names), _value(b, names)
        else:
            start = end = _value(part, names)
            if step > 1:
                end = hi
        if not (lo <= start <= hi and lo <= end <= hi and start <= end):
            raise CronError(f"field {field!r} out of range [{lo},{hi}]")
        out.update(range(start, end + 1, step))
    return out, wildcard


def _value(token: str, names: dict[str, int]) -> int:
    token = token.strip().lower()
    if token in names:
        return names[token]
    v = int(token)
    if names is _DOW_NAMES and v == 7:  # both 0 and 7 are Sunday
        return 0
    return v


class Schedule:
    def __init__(self, expr: str):
        expr = _ALIASES.get(expr.strip(), expr.strip())
        fields = expr.split()
        if len(fields) != 5:
            raise CronError(f"expected 5 cron fields, got {len(fields)} in {expr!r}")
        self.minutes, _ = _parse_field(fields[0], 0, 59, {})
        self.hours, _ = _parse_field(fields[1], 0, 23, {})
        self.dom, self.dom_wild = _parse_field(fields[2], 1, 31, {})
        self.months, _ = _parse_field(fields[3], 1, 12, _MONTH_NAMES)
        self.dow, self.dow_wild = _parse_field(fields[4], 0, 6, _DOW_NAMES)

    def _day_matches(self, dt: datetime) -> bool:
        dom_ok = dt.day in self.dom
        # cron dow: 0=Sunday; python weekday(): 0=Monday
        dow_ok = ((dt.weekday() + 1) % 7) in self.dow
        # standard cron: if both dom and dow are restricted, OR them
        if not self.dom_wild and not self.dow_wild:
            return dom_ok or dow_ok
        return dom_ok and dow_ok

    def last_fire(self, now: float) -> Optional[float]:
        """Most recent fire time <= now, or None within a 2-year lookback."""
        dt = datetime.fromtimestamp(now, tz=timezone.utc).replace(second=0, microsecond=0)
        day = dt
        for i in range(366 * 2):
            if day.month in self.months and self._day_matches(day):
                max_h = dt.hour if i == 0 else 23
                for h in sorted((x for x in self.hours if x <= max_h), reverse=True):
                    max_m = dt.minute if (i == 0 and h == dt.hour) else 59
                    ms = [x for x in self.minutes if x <= max_m]
                    if ms:
                        fire = day.replace(hour=h, minute=max(ms))
                        return fire.timestamp()
            day = (day - timedelta(days=1)).replace(hour=23, minute=59)
        return None


def last_fire_time(schedule: str, now: float) -> Optional[float]:
    return Schedule(schedule).last_fire(now)


def validate(schedule: str) -> Optional[str]:
    try:
        Schedule(schedule)
        return None
    except (CronError, ValueError) as e:
        return str(e)
