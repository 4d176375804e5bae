"""The reference's dispatch tier names and the port's, for the tests that
hold the port's diagnostics to the reference's texts
(``tests/golden/kernelcheck/*.txt``, ``Database.explain``).

The reference's hardware tiers are ``pallas`` (the TPU kernels) and
``interpret`` (the same kernels in Pallas' interpreter on the CPU); the
port's one hardware tier is ``cuda`` (the hand-written kernels), which the
CPU tests reach through its plain versions. So both reference names map to
``cuda``; ``sanitizer`` and ``ref`` keep their names, and the reference's
default lowering ``jnp`` is the port's ``torch``. Nothing else in a text
changes.
"""

import re

TIER_NAMES = {"pallas": "cuda", "interpret": "cuda", "jnp": "torch"}

_QUOTED = re.compile(r"(['\":])(" + "|".join(TIER_NAMES) + r")(?=['\":\n,]|$)")


def map_tiers(text: str) -> str:
    """``text`` with each reference tier name, where it stands as a name
    (quoted, or after a ``:`` in a node path), replaced by the port's."""
    return _QUOTED.sub(lambda m: m.group(1) + TIER_NAMES[m.group(2)], text)
