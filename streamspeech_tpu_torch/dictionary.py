"""Symbol dictionary with fairseq's index layout: ``<s>``(0) ``<pad>``(1)
``</s>``(2) ``<unk>``(3), then the file symbols in order; a CTC ``<blank>`` is
appended last (`researches/ctc_unity/tasks/speech_to_speech_ctc.py:14-19`).
The same layout as ``streamspeech_tpu/dictionary.py``, kept here so the port
imports nothing of the JAX package. Dict files are ``"<symbol> <count>"``
lines (``load`` / ``save``)."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional


class Dictionary:
    def __init__(self):
        self.symbols: List[str] = []
        self.count: List[int] = []
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

    def add_symbol(self, word: str, n: int = 1) -> int:
        if word in self.indices:
            self.count[self.indices[word]] += n
        else:
            self.indices[word] = len(self.symbols)
            self.symbols.append(word)
            self.count.append(n)
        return self.indices[word]

    def add_blank(self, symbol: str = "<blank>") -> int:
        self.blank_index = self.add_symbol(symbol)
        return self.blank_index

    def index(self, word: str) -> int:
        return self.indices.get(word, self.unk_index)

    def bos(self) -> int:
        return self.bos_index

    def pad(self) -> int:
        return self.pad_index

    def eos(self) -> int:
        return self.eos_index

    def unk(self) -> int:
        return self.unk_index

    def encode_line(self, line: str, append_eos: bool = True,
                    add_if_not_exist: bool = False) -> List[int]:
        """Whitespace-split symbols → ids (unknown → ``<unk>``, or added)."""
        ids = [self.add_symbol(w) if add_if_not_exist else self.index(w)
               for w in line.split()]
        if append_eos:
            ids.append(self.eos_index)
        return ids

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
    def load(cls, path: str) -> "Dictionary":
        """A fairseq dict file (`dictionary.py:121`): one ``symbol count`` a
        line, the count optional (1); blank lines skipped."""
        d = cls()
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                try:
                    word, cnt = line.rsplit(" ", 1)
                    n = int(cnt)
                except ValueError:
                    word, n = line, 1
                d.add_symbol(word, n)
        return d

    def save(self, path: str) -> None:
        """The symbols after the specials, one ``symbol count`` a line."""
        with open(path, "w", encoding="utf-8") as f:
            for sym, cnt in zip(self.symbols[self.nspecial:], self.count[self.nspecial:]):
                f.write(f"{sym} {cnt}\n")

    @classmethod
    def units(cls, code_size: int) -> "Dictionary":
        """Unit dictionary: symbols "0".."code_size-1" after the 4 specials."""
        d = cls()
        for i in range(code_size):
            d.add_symbol(str(i))
        return d
