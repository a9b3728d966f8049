"""Message-converting signature-scheme adapter.

The port's own copy of `openzl_tpu/crypto/signature/convert.py` (host
Python, no JAX).

Reference parity: openzl-crypto/src/signature/convert.rs:26-80 — the
`Forward` conversion trait (structured source message -> the base scheme's
target message) and the `Converter<S, C>` adapter that applies it before
`sign` and `verify` while passing keys, randomness, and signatures through
unchanged. The Rust version is ~217 LoC of trait plumbing; duck typing
reduces it to the composition itself (the same dissolution as
encryption/convert.py's ConvertedScheme).
"""

from __future__ import annotations

import dataclasses
from typing import Callable


def _identity(x):
    return x


@dataclasses.dataclass(frozen=True)
class Converter:
    """Wrap signature scheme `base` with a message conversion.

    forward_message: outer (structured) message -> base message
    (convert.rs `Forward::as_target`). Key generation, key derivation,
    randomness, and signature types are the base scheme's own
    (convert.rs SigningKeyType/VerifyingKeyType/SignatureType impls).
    """

    base: object
    forward_message: Callable = _identity

    def into_inner(self):
        """The wrapped base scheme (convert.rs Converter::into_inner)."""
        return self.base

    def generate_key(self, rng):
        return self.base.generate_key(rng)

    def derive(self, signing_key):
        return self.base.derive(signing_key)

    def sign(self, signing_key, randomness, msg):
        return self.base.sign(signing_key, randomness, self.forward_message(msg))

    def verify(self, vk, msg, sig) -> bool:
        return self.base.verify(vk, self.forward_message(msg), sig)
