"""Node-level JSON config I/O.

A copy of ``hotstuff_tpu.node.config`` (reference
``node/src/config.rs:21-85``): ``Secret`` keypair files, committee files
and parameters files, written byte for byte as the JAX package writes
them, for both schemes (a BLS key file carries its proof of
possession).
"""

from __future__ import annotations

import json
import os

from ..consensus import Committee, Parameters
from ..crypto import PublicKey
from ..crypto.scheme import keygen_production, read_secret


class ConfigError(Exception):
    pass


def _read_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ConfigError(f"Failed to read config file '{path}': {e}") from e


def _write_json(path: str, data: dict) -> None:
    try:
        with open(path, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
            f.write("\n")
    except OSError as e:
        raise ConfigError(f"Failed to write config file '{path}': {e}") from e


class Secret:
    """A node's identity: {name, secret, scheme[, pop]} as base64 JSON
    (reference node/src/config.rs:52-68; ``scheme`` is this framework's
    addition — "ed25519" default, "bls" for BLS12-381 committees).

    For BLS keys the file also records the proof of possession: it is
    public committee material (``Authority.pop``) that the operator
    pastes into the committee file next to the public key — publishing
    a BLS key without it is useless, since ``Consensus.spawn`` refuses
    PoP-less BLS committees (rogue-key defence)."""

    def __init__(
        self,
        name: PublicKey,
        secret,
        scheme: str = "ed25519",
        pop: bytes | None = None,
    ):
        self.name = name
        self.secret = secret  # SecretKey (ed25519) or OpaqueSecret (bls)
        self.scheme = scheme
        self.pop = pop

    @classmethod
    def new(cls, scheme: str = "ed25519") -> "Secret":
        name, secret = keygen_production(scheme)
        pop = None
        if scheme == "bls":
            from ..crypto.scheme import bls_pop

            pop = bls_pop(secret.to_bytes())
        return cls(name, secret, scheme, pop)

    def write(self, path: str) -> None:
        import base64

        data = {
            "name": self.name.encode_base64(),
            "secret": self.secret.encode_base64(),
            "scheme": self.scheme,
        }
        if self.pop is not None:
            data["pop"] = base64.b64encode(self.pop).decode()
        _write_json(path, data)
        os.chmod(path, 0o600)

    @classmethod
    def read(cls, path: str) -> "Secret":
        import base64

        data = _read_json(path)
        scheme = data.get("scheme", "ed25519")
        return cls(
            PublicKey.decode_base64(data["name"]),
            read_secret(scheme, data["secret"]),
            scheme,
            base64.b64decode(data["pop"]) if "pop" in data else None,
        )


def write_committee(committee: Committee, path: str) -> None:
    """Accepts a Committee or a CommitteeSchedule (epoch handoff) —
    both carry their own to_json shape."""
    _write_json(path, {"consensus": committee.to_json()})


def read_committee(path: str) -> Committee:
    """Returns a Committee, or a CommitteeSchedule when the file holds
    one (a ``schedule`` key) — callers use them interchangeably via the
    for_round seam."""
    from ..consensus.config import committee_from_json

    data = _read_json(path)
    return committee_from_json(data.get("consensus", data))


def write_parameters(parameters: Parameters, path: str) -> None:
    _write_json(path, {"consensus": parameters.to_json()})


def read_parameters(path: str) -> Parameters:
    data = _read_json(path)
    return Parameters.from_json(data.get("consensus", data))
