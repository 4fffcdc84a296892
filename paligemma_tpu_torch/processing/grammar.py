"""Grammar-constrained decoding: regex -> byte DFA -> token-level tables
(the port's own copy of paligemma_tpu/processing/grammar.py: numpy and the
standard library only).

This module is the HOST half of constrained decoding: compile a regex (or a
literal-choice list) into a byte-level DFA, then close it over the tokenizer
vocabulary into a dense ``(num_states, vocab)`` int16 transition table —
``table[s, t]`` is the DFA state after appending token ``t``'s text in state
``s``, or ``-1`` if that text is not a prefix of any string the grammar
accepts. The DEVICE half (runtime/serving.py) carries one ``(B,)`` DFA-state
tensor and masks logits with ``table[gid, state] >= 0`` inside the tick:
one (B, vocab) gather + where per step, no host round trip.

EOS convention: the EOS token is allowed exactly in ACCEPTING states
(where it self-loops), so a constrained row can only stop on a complete
match and the serving engine's ordinary EOS retirement finishes it. A
state with no outgoing token at all (a grammar/tokenizer mismatch cul-
de-sac) falls back to allowing EOS so generation can never wedge.

Regex subset: literals, ``.``, ``[...]`` classes (ranges, negation),
groups, ``|``, ``*``, ``+``, ``?``, ``{m}``/``{m,n}`` repetition, and
``\\d \\w \\s \\n \\t \\r \\\\`` escapes, over UTF-8 BYTES (multi-byte
literals work; classes/dot range over single bytes).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

_ANY = tuple(range(1, 256))  # '.' — any byte except NUL


# ---------------------------------------------------------------------------
# Regex subset -> NFA (Thompson construction)
# ---------------------------------------------------------------------------
class _Nfa:
    """Fragment NFA: integer states, eps + byte-set edges."""

    def __init__(self):
        self.eps: List[Set[int]] = []
        self.edges: List[List[Tuple[Tuple[int, ...], int]]] = []

    def new_state(self) -> int:
        self.eps.append(set())
        self.edges.append([])
        return len(self.eps) - 1


class _Parser:
    """Recursive-descent parser for the documented regex subset."""

    def __init__(self, pattern: str, nfa: _Nfa):
        self.p = pattern
        self.i = 0
        self.nfa = nfa

    def _peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def _take(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self) -> Tuple[int, int]:
        frag = self._alt()
        if self.i != len(self.p):
            raise ValueError(
                f"regex parse error at index {self.i}: unexpected "
                f"{self.p[self.i]!r} in {self.p!r}"
            )
        return frag

    def _alt(self) -> Tuple[int, int]:
        frags = [self._concat()]
        while self._peek() == "|":
            self._take()
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        s, e = self.nfa.new_state(), self.nfa.new_state()
        for fs, fe in frags:
            self.nfa.eps[s].add(fs)
            self.nfa.eps[fe].add(e)
        return s, e

    def _concat(self) -> Tuple[int, int]:
        frags = []
        while self._peek() is not None and self._peek() not in "|)":
            frags.append(self._repeat())
        if not frags:
            s = self.nfa.new_state()
            return s, s
        s, e = frags[0]
        for fs, fe in frags[1:]:
            self.nfa.eps[e].add(fs)
            e = fe
        return s, e

    def _repeat(self) -> Tuple[int, int]:
        frag = self._atom()
        while self._peek() in ("*", "+", "?", "{"):
            op = self._take()
            if op == "{":
                j = self.p.index("}", self.i)
                spec = self.p[self.i : j]
                self.i = j + 1
                lo, _, hi = spec.partition(",")
                m = int(lo)
                n = m if not _ else (int(hi) if hi else None)
                frag = self._times(frag, m, n)
            elif op == "*":
                frag = self._star(frag)
            elif op == "+":
                fs2, fe2 = self._copy(frag)
                st = self._star((fs2, fe2))
                self.nfa.eps[frag[1]].add(st[0])
                frag = (frag[0], st[1])
            else:  # ?
                self.nfa.eps[frag[0]].add(frag[1])
        return frag

    def _star(self, frag: Tuple[int, int]) -> Tuple[int, int]:
        s, e = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.eps[s].update((frag[0], e))
        self.nfa.eps[frag[1]].update((frag[0], e))
        return s, e

    def _copy(self, frag: Tuple[int, int]) -> Tuple[int, int]:
        """Deep-copy a fragment's reachable subgraph (for + and {m,n})."""
        seen: Dict[int, int] = {}
        stack = [frag[0]]
        while stack:
            st = stack.pop()
            if st in seen:
                continue
            seen[st] = self.nfa.new_state()
            stack.extend(self.nfa.eps[st])
            stack.extend(t for _, t in self.nfa.edges[st])
        for old, new in seen.items():
            self.nfa.eps[new].update(seen[t] for t in self.nfa.eps[old])
            self.nfa.edges[new].extend(
                (bs, seen[t]) for bs, t in self.nfa.edges[old]
            )
        return seen[frag[0]], seen[frag[1]]

    def _times(self, frag, m: int, n: Optional[int]) -> Tuple[int, int]:
        # chain of m required copies then (n-m) optional ones (or a star
        # for {m,}); the original fragment is left orphaned — harmless,
        # subset construction only walks reachable states
        parts = [self._copy(frag) for _ in range(m)]
        if n is None:  # {m,} == m copies + star
            parts.append(self._star(self._copy(frag)))
        else:
            for _ in range(n - m):
                fs, fe = self._copy(frag)
                self.nfa.eps[fs].add(fe)  # optional copy
                parts.append((fs, fe))
        if not parts:  # {0} — matches only the empty string
            s = self.nfa.new_state()
            return s, s
        s, e = parts[0]
        for fs, fe in parts[1:]:
            self.nfa.eps[e].add(fs)
            e = fe
        return s, e

    _CLASSES = {
        "d": tuple(range(ord("0"), ord("9") + 1)),
        "w": tuple(
            list(range(ord("a"), ord("z") + 1))
            + list(range(ord("A"), ord("Z") + 1))
            + list(range(ord("0"), ord("9") + 1))
            + [ord("_")]
        ),
        "s": (ord(" "), ord("\t"), ord("\n"), ord("\r")),
        "n": (ord("\n"),),
        "t": (ord("\t"),),
        "r": (ord("\r"),),
    }

    def _atom(self) -> Tuple[int, int]:
        ch = self._take()
        if ch == "(":
            frag = self._alt()
            if self._peek() != ")":
                raise ValueError(f"unclosed group in {self.p!r}")
            self._take()
            return frag
        if ch == "[":
            return self._byte_edge(self._char_class())
        if ch == ".":
            return self._byte_edge(_ANY)
        if ch == "\\":
            esc = self._take()
            if esc in self._CLASSES:
                return self._byte_edge(self._CLASSES[esc])
            return self._literal(esc)
        if ch in "*+?{}|)":
            raise ValueError(f"unexpected {ch!r} at {self.i - 1} in {self.p!r}")
        return self._literal(ch)

    def _literal(self, ch: str) -> Tuple[int, int]:
        bs = ch.encode("utf-8")
        s = self.nfa.new_state()
        cur = s
        for b in bs:
            nxt = self.nfa.new_state()
            self.nfa.edges[cur].append(((b,), nxt))
            cur = nxt
        return s, cur

    def _byte_edge(self, byte_set: Tuple[int, ...]) -> Tuple[int, int]:
        s, e = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.edges[s].append((tuple(byte_set), e))
        return s, e

    def _char_class(self) -> Tuple[int, ...]:
        negate = self._peek() == "^"
        if negate:
            self._take()
        members: Set[int] = set()
        while self._peek() != "]":
            if self._peek() is None:
                raise ValueError(f"unclosed [ in {self.p!r}")
            ch = self._take()
            if ch == "\\":
                esc = self._take()
                if esc in self._CLASSES:
                    members.update(self._CLASSES[esc])
                    continue
                ch = esc
            b = ch.encode("utf-8")
            if len(b) != 1:
                raise ValueError(
                    f"non-ASCII {ch!r} in char class (classes are per-byte)"
                )
            if self._peek() == "-" and self.p[self.i + 1] != "]":
                self._take()
                hi = self._take().encode("utf-8")
                if len(hi) != 1:
                    raise ValueError("non-ASCII range end in char class")
                members.update(range(b[0], hi[0] + 1))
            else:
                members.add(b[0])
        self._take()
        if negate:
            return tuple(x for x in range(1, 256) if x not in members)
        return tuple(sorted(members))


# ---------------------------------------------------------------------------
# NFA -> byte DFA (subset construction)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ByteDFA:
    """Dense byte-level DFA: ``next[s, b]`` (-1 = reject), state 0 = start."""

    next: np.ndarray  # (S, 256) int32
    accepting: np.ndarray  # (S,) bool

    def matches(self, text: str) -> bool:
        s = 0
        for b in text.encode("utf-8"):
            s = int(self.next[s, b])
            if s < 0:
                return False
        return bool(self.accepting[s])

    def is_live_prefix(self, text: str) -> bool:
        s = 0
        for b in text.encode("utf-8"):
            s = int(self.next[s, b])
            if s < 0:
                return False
        return True


def compile_regex(pattern: str, max_states: int = 4096) -> ByteDFA:
    """Regex (documented subset) -> minimized-enough byte DFA."""
    nfa = _Nfa()
    start, end = _Parser(pattern, nfa).parse()

    def closure(states: FrozenSet[int]) -> FrozenSet[int]:
        out = set(states)
        stack = list(states)
        while stack:
            for t in nfa.eps[stack.pop()]:
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    start_c = closure(frozenset({start}))
    index: Dict[FrozenSet[int], int] = {start_c: 0}
    rows: List[np.ndarray] = []
    acc: List[bool] = []
    work = [start_c]
    while work:
        cur = work.pop(0)
        row = np.full((256,), -1, np.int64)
        # byte -> union of targets
        targets: Dict[int, Set[int]] = {}
        for st in cur:
            for byte_set, t in nfa.edges[st]:
                for b in byte_set:
                    targets.setdefault(b, set()).add(t)
        for b, ts in targets.items():
            nxt = closure(frozenset(ts))
            if nxt not in index:
                if len(index) >= max_states:
                    raise ValueError(
                        f"regex {pattern!r} exceeds {max_states} DFA states"
                    )
                index[nxt] = len(index)
                work.append(nxt)
            row[b] = index[nxt]
        rows.append(row)
        acc.append(end in cur)
    return ByteDFA(
        next=np.stack(rows).astype(np.int32), accepting=np.asarray(acc)
    )


def compile_choices(options: Sequence[str]) -> ByteDFA:
    """Literal-choice grammar (a trie DFA): output must be one of these."""
    if not options:
        raise ValueError("compile_choices needs at least one option")
    trie: Dict[Tuple[int, ...], int] = {(): 0}
    acc: Set[int] = set()
    edges: List[Dict[int, int]] = [{}]
    for opt in options:
        prefix: Tuple[int, ...] = ()
        for b in opt.encode("utf-8"):
            nxt = prefix + (b,)
            if nxt not in trie:
                trie[nxt] = len(edges)
                edges.append({})
            edges[trie[prefix]][b] = trie[nxt]
            prefix = nxt
        acc.add(trie[prefix])
    table = np.full((len(edges), 256), -1, np.int32)
    for s, row in enumerate(edges):
        for b, t in row.items():
            table[s, b] = t
    accepting = np.zeros((len(edges),), bool)
    accepting[list(acc)] = True
    return ByteDFA(next=table, accepting=accepting)


# ---------------------------------------------------------------------------
# Byte DFA x tokenizer vocabulary -> token-level table
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TokenDFA:
    """Token-level grammar table for the serving engine.

    ``table[s, t]``: state after token ``t`` in state ``s`` (-1 rejects).
    EOS is allowed (self-loop) exactly in accepting states; states with no
    other way out allow EOS too (fail-safe, see module docstring).
    """

    table: np.ndarray  # (S, V) int16
    eos_token_id: int

    @property
    def num_states(self) -> int:
        return self.table.shape[0]


def token_strings_from_tokenizer(tokenizer, vocab_size: int) -> List[str]:
    """Per-token surface text under CONCATENATION semantics.

    SentencePiece marks word starts with U+2581; byte-level BPE uses
    U+0120 for space. Tokens that don't correspond to generatable text
    (special tokens, None) map to "" and are disallowed by the closure.
    """
    toks = tokenizer.convert_ids_to_tokens(list(range(vocab_size)))
    special = set(getattr(tokenizer, "all_special_ids", []) or [])
    out = []
    for i, t in enumerate(toks):
        if t is None or i in special:
            out.append("")
            continue
        out.append(t.replace("▁", " ").replace("Ġ", " "))
    return out


def compile_token_dfa(
    dfa: ByteDFA,
    token_strs: Sequence[str],
    eos_token_id: int,
) -> TokenDFA:
    """Close a byte DFA over the vocabulary (vectorized over tokens).

    Cost: O(num_states x max_token_len) numpy passes over the vocab.
    """
    v = len(token_strs)
    if not 0 <= eos_token_id < v:
        raise ValueError(f"eos_token_id {eos_token_id} outside vocab {v}")
    byte_rows = [s.encode("utf-8") for s in token_strs]
    max_len = max((len(b) for b in byte_rows), default=1) or 1
    bytes_mat = np.zeros((v, max_len), np.int32)
    lens = np.zeros((v,), np.int32)
    for i, b in enumerate(byte_rows):
        lens[i] = len(b)
        bytes_mat[i, : len(b)] = np.frombuffer(b, np.uint8)

    S = dfa.next.shape[0]
    # dead-state row so walks stay vectorized: next[dead] == dead
    nxt = np.concatenate([dfa.next, np.full((1, 256), S, np.int32)])
    nxt = np.where(nxt < 0, S, nxt)  # -1 -> dead
    table = np.full((S, v), -1, np.int32)
    empties = lens == 0  # specials / empty strings: never allowed
    for s in range(S):
        cur = np.full((v,), s, np.int32)
        for j in range(max_len):
            step = nxt[cur, bytes_mat[:, j]]
            cur = np.where(j < lens, step, cur)
        cur = np.where(empties, S, cur)  # disallow zero-length tokens
        table[s] = np.where(cur == S, -1, cur)
        table[s, eos_token_id] = s if dfa.accepting[s] else -1
        if (table[s] >= 0).sum() == 0:
            # cul-de-sac (grammar x tokenizer mismatch): allow EOS so a
            # constrained row can never wedge the batch
            table[s, eos_token_id] = s
    if S >= 2**15:
        raise ValueError(f"{S} DFA states exceed the int16 table range")
    return TokenDFA(table=table.astype(np.int16), eos_token_id=eos_token_id)
