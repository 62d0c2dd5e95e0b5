"""Time/length unit constants (reference ``src/Units.jl:1-40``); a copy of
``oceananigans_tpu/utils/units.py``."""

second = seconds = 1.0
minute = minutes = 60.0
hour = hours = 3600.0
day = days = 86_400.0
year = years = 365 * day

meter = meters = 1.0
kilometer = kilometers = 1000.0

KiB = 2 ** 10
MiB = 2 ** 20
GiB = 2 ** 30
TiB = 2 ** 40

__all__ = ["second", "seconds", "minute", "minutes", "hour", "hours",
           "day", "days", "year", "years", "meter", "meters",
           "kilometer", "kilometers", "KiB", "MiB", "GiB", "TiB"]
