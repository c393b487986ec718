"""argparse extensions.

Copy of ``dmlcloud_tpu/utils/argparse_ext.py``: an ``EnumAction`` that exposes
an Enum as a choice flag, mapping by lowercase member name.
"""

from __future__ import annotations

import argparse
import enum


class EnumAction(argparse.Action):
    """Argparse action for Enum-valued flags: ``--reduction mean``.

    Usage::

        parser.add_argument('--reduction', type=Reduction, action=EnumAction)
    """

    def __init__(self, **kwargs):
        enum_type = kwargs.pop("type", None)
        if enum_type is None or not issubclass(enum_type, enum.Enum):
            raise TypeError("EnumAction requires `type=<Enum subclass>`")
        kwargs.setdefault("choices", tuple(e.name.lower() for e in enum_type))
        super().__init__(**kwargs)
        self._enum = enum_type

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, self._enum[values.upper()])
