"""Comparison helpers shared by the port's tests against the reference."""

import dataclasses
import math

import repro.core as R


def plain(x):
    """Dataclasses, dicts, lists and tuples as nested tuples, NaN made
    comparable with ``==``, so records of the two packages compare."""
    if dataclasses.is_dataclass(x):
        return tuple(plain(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return tuple((k, plain(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def ref_spec(spec):
    """The reference's ``SweepSpec`` for a port ``SweepSpec`` (its fields,
    without the port's ``device``)."""
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(R.SweepSpec)}
    if spec.adapt is not None:
        fields["adapt"] = R.AdaptConfig(**dataclasses.asdict(spec.adapt))
    return R.SweepSpec(**fields)
