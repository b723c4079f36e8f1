"""Symbol dictionary with fairseq's index layout: ``<s>``(0) ``<pad>``(1)
``</s>``(2) ``<unk>``(3), then the file symbols in order; a CTC ``<blank>`` is
appended last (`researches/ctc_unity/tasks/speech_to_speech_ctc.py:14-19`).
The same layout as ``streamspeech_tpu/dictionary.py``, kept here so the port
imports nothing of the JAX package."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional


class Dictionary:
    def __init__(self):
        self.symbols: List[str] = []
        self.indices: Dict[str, int] = {}
        self.bos_index = self.add_symbol("<s>")
        self.pad_index = self.add_symbol("<pad>")
        self.eos_index = self.add_symbol("</s>")
        self.unk_index = self.add_symbol("<unk>")
        self.unk_word = "<unk>"
        self.nspecial = len(self.symbols)
        self.blank_index: Optional[int] = None

    def __len__(self) -> int:
        return len(self.symbols)

    def __getitem__(self, idx: int) -> str:
        if 0 <= idx < len(self.symbols):
            return self.symbols[idx]
        return self.unk_word

    def add_symbol(self, word: str) -> int:
        if word not in self.indices:
            self.indices[word] = len(self.symbols)
            self.symbols.append(word)
        return self.indices[word]

    def add_blank(self, symbol: str = "<blank>") -> int:
        self.blank_index = self.add_symbol(symbol)
        return self.blank_index

    def blank(self) -> int:
        if self.blank_index is None:
            raise ValueError("dictionary has no <blank>; call add_blank() first")
        return self.blank_index

    def string(self, ids: Iterable[int], spm_to_text: bool = False) -> str:
        special = {self.bos_index, self.pad_index, self.eos_index,
                   self.blank_index}
        s = " ".join(self[int(i)] for i in ids if int(i) not in special)
        if spm_to_text:
            s = s.replace(" ", "").replace("▁", " ").strip()
        return s

    @classmethod
    def units(cls, code_size: int) -> "Dictionary":
        """Unit dictionary: symbols "0".."code_size-1" after the 4 specials."""
        d = cls()
        for i in range(code_size):
            d.add_symbol(str(i))
        return d
