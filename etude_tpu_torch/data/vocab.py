"""Token ⇄ ID vocabulary.

The port's own copy of etude_tpu/data/vocab.py, kept so that etude_tpu_torch
imports nothing of the JAX package.

Data contract matches the reference (etude/data/vocab.py): tokens are
"{type}_{value}" strings, specials <PAD>/<UNK>/<BOS>/<EOS> occupy IDs 0-3, and
vocab.json persists {token_to_id, special_tokens} so vocabulary files are
interchangeable between the two frameworks.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Union

PAD_TOKEN = "<PAD>"
UNK_TOKEN = "<UNK>"
BOS_TOKEN = "<BOS>"
EOS_TOKEN = "<EOS>"

# Event types whose values are integers when decoded back from strings.
_INT_VALUE_TYPES = {"Note", "Pos", "TimeSig", "Duration", "Grace"}


@dataclass
class Event:
    """A single musical event; str(event) is its vocabulary token."""

    type_: str
    value: Union[str, int]

    def __str__(self) -> str:
        return f"{self.type_}_{self.value}"

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Event({self.type_}, {self.value})"


class Vocab:
    """Bidirectional token/ID mapping with JSON persistence."""

    def __init__(self, special_tokens: List[str] = None):
        if special_tokens is None:
            special_tokens = [PAD_TOKEN, UNK_TOKEN, BOS_TOKEN, EOS_TOKEN]
        self.special_tokens = list(special_tokens)
        self.token_to_id: Dict[str, int] = {}
        self.id_to_token: List[str] = []
        for tok in self.special_tokens:
            self.add(tok)

    # ---- construction --------------------------------------------------
    def add(self, token: str) -> int:
        existing = self.token_to_id.get(token)
        if existing is not None:
            return existing
        token_id = len(self.id_to_token)
        self.token_to_id[token] = token_id
        self.id_to_token.append(token)
        return token_id

    # ---- encode / decode ----------------------------------------------
    def encode(self, token: Union[str, Event]) -> int:
        token_str = str(token)
        token_id = self.token_to_id.get(token_str)
        if token_id is not None:
            return token_id
        unk = self.token_to_id.get(UNK_TOKEN)
        if unk is None:
            raise KeyError(
                f"token {token_str!r} not in vocabulary and no {UNK_TOKEN} fallback"
            )
        return unk

    def decode(self, token_id: int) -> str:
        if 0 <= token_id < len(self.id_to_token):
            return self.id_to_token[token_id]
        raise ValueError(f"invalid token id: {token_id}")

    def decode_to_event(self, token_id: int) -> Event:
        token_str = self.decode(token_id)
        if token_str in self.special_tokens:
            return Event(type_=token_str, value="")
        if "_" in token_str:
            type_, value_str = token_str.split("_", 1)
            if type_ in _INT_VALUE_TYPES:
                try:
                    return Event(type_=type_, value=int(value_str))
                except ValueError:
                    pass
            return Event(type_=type_, value=value_str)
        return Event(type_=token_str, value="")

    def encode_sequence(self, sequence: Iterable[Union[str, Event]]) -> List[int]:
        return [self.encode(t) for t in sequence]

    def decode_sequence_to_events(self, id_sequence: Iterable[int]) -> List[Event]:
        pad = self.pad_id
        return [self.decode_to_event(i) for i in id_sequence if i != pad]

    # ---- persistence ---------------------------------------------------
    def save(self, filepath: Union[str, Path]) -> None:
        filepath = Path(filepath)
        filepath.parent.mkdir(parents=True, exist_ok=True)
        with open(filepath, "w", encoding="utf-8") as f:
            json.dump(
                {"token_to_id": self.token_to_id, "special_tokens": self.special_tokens},
                f,
                ensure_ascii=False,
                indent=2,
            )

    @classmethod
    def load(cls, filepath: Union[str, Path]) -> "Vocab":
        filepath = Path(filepath)
        with open(filepath, "r", encoding="utf-8") as f:
            data = json.load(f)
        vocab = cls(special_tokens=data.get("special_tokens", [PAD_TOKEN]))
        vocab.token_to_id = {str(k): int(v) for k, v in data["token_to_id"].items()}
        vocab.id_to_token = [""] * len(vocab.token_to_id)
        for token, token_id in vocab.token_to_id.items():
            vocab.id_to_token[token_id] = token
        return vocab

    # ---- helpers -------------------------------------------------------
    def __len__(self) -> int:
        return len(self.id_to_token)

    @property
    def pad_id(self) -> int:
        return self.token_to_id.get(PAD_TOKEN, -1)

    @property
    def bar_bos_id(self) -> int:
        return self.token_to_id.get("Bar_BOS", -1)

    @property
    def bar_eos_id(self) -> int:
        return self.token_to_id.get("Bar_EOS", -1)
