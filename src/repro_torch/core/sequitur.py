"""Sequitur grammar induction with run-length exponents.

The paper (Section 3.1) compresses the per-process stream of call-signature
terminals into a context-free grammar using Sequitur [Nevill-Manning &
Witten].  Plain Sequitur represents ``a^n`` as an O(log n) tower of binary
rules; the paper (following Pilgrim [19, 20]) shows rules of the form
``S -> A^m``, i.e. symbols carry repetition exponents.  We implement
exponent-carrying Sequitur:

  * every symbol node is ``(sym, exp)``; appending a terminal equal to the
    tail symbol increments the tail's exponent (streaming RLE),
  * digrams are keyed on both symbols *and* exponents, so a repeated loop
    body ``(a,n)(b,1)`` forms one rule regardless of ``n``,
  * adjacent equal symbols are always merged, which also removes the classic
    overlapping-digram corner case of textbook Sequitur.

The two Sequitur invariants are maintained:
  digram uniqueness -- no digram appears more than once in the grammar,
  rule utility      -- every rule is referenced more than once (a rule whose
                       reference count drops to one occurrence with exponent
                       one is inlined).

Complexity is amortized O(1) per appended terminal.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from .encoding import pack_uvarints, read_uvarint, write_uvarint

Key = Tuple[int, int, int]  # (is_rule, sym_or_rule_id, exp)


class Symbol:
    __slots__ = ("term", "rule", "exp", "prev", "next")

    def __init__(self, term: Optional[int], rule: Optional["Rule"], exp: int):
        self.term = term          # terminal id (>= 0) or None
        self.rule = rule          # Rule reference or None
        self.exp = exp
        self.prev: Optional[Symbol] = None
        self.next: Optional[Symbol] = None

    @property
    def is_guard(self) -> bool:
        return self.exp == 0

    def key(self) -> Key:
        if self.rule is not None:
            return (1, self.rule.id, self.exp)
        return (0, self.term, self.exp)  # type: ignore[return-value]

    def same_sym(self, other: "Symbol") -> bool:
        if self.rule is not None:
            return other.rule is self.rule
        return other.rule is None and other.term == self.term

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        if self.is_guard:
            return f"<guard R{self.rule.id}>"
        base = f"R{self.rule.id}" if self.rule is not None else f"t{self.term}"
        return f"{base}^{self.exp}"


class Rule:
    __slots__ = ("id", "guard", "users")

    def __init__(self, rid: int):
        self.id = rid
        g = Symbol(None, self, 0)  # guard: exp 0, rule back-reference
        g.prev = g
        g.next = g
        self.guard = g
        # symbol nodes elsewhere in the grammar that reference this rule
        self.users: set = set()

    def body(self) -> Iterator[Symbol]:
        n = self.guard.next
        while n is not self.guard:
            yield n
            n = n.next

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"R{self.id} -> " + " ".join(repr(s) for s in self.body())


class Sequitur:
    """Online exponent-Sequitur over integer terminals."""

    def __init__(self) -> None:
        self._next_rule_id = 0
        self.start = self._new_rule()
        self.index: Dict[Tuple[Key, Key], Symbol] = {}
        self.n_pushed = 0  # total terminals (with multiplicity)

    # -- public API ---------------------------------------------------------

    def push(self, terminal: int, count: int = 1) -> None:
        """Append ``terminal`` repeated ``count`` times to the sequence."""
        if count <= 0:
            raise ValueError("count must be positive")
        self.n_pushed += count
        g = self.start.guard
        tail = g.prev
        if not tail.is_guard and tail.rule is None and tail.term == terminal:
            # streaming RLE: bump the tail's exponent in place
            self._unindex_digram(tail.prev)
            tail.exp += count
            self._scan_digram(tail.prev)
        else:
            node = Symbol(terminal, None, count)
            self._splice_after(tail, node)
            self._scan_digram(node.prev)

    def push_stream(self, terminals, backend: Optional[str] = None) -> None:
        """Append a whole terminal array with RLE pre-tokenization.

        Run boundaries are found in one batched pass
        (``encode_backend.run_starts``: NumPy or the grammar_stats
        kernel) and each maximal run enters the grammar as a single
        ``push(term, run_len)`` -- the batch semantics of the existing
        exponent API, so the expansion is always identical to per-terminal
        pushes and the grammar is identical to calling
        ``push(t, k)`` per run.  The ``python`` backend is the per-run
        scalar reference."""
        import numpy as np
        arr = np.asarray(terminals, dtype=np.int64).reshape(-1)
        n = int(arr.size)
        if n == 0:
            return
        from . import encode_backend as _eb
        eff = _eb.resolve(backend, n)
        if eff == "python":
            run_start = 0
            vals = arr.tolist()
            for i in range(1, n):
                if vals[i] != vals[run_start]:
                    self.push(vals[run_start], i - run_start)
                    run_start = i
            self.push(vals[run_start], n - run_start)
            return
        starts = _eb.run_starts(arr[:, None], eff)
        ends = np.append(starts[1:], n)
        for s, e in zip(starts.tolist(), ends.tolist()):
            self.push(int(arr[s]), e - s)

    def rules(self) -> List[Rule]:
        seen: Dict[int, Rule] = {}
        stack = [self.start]
        while stack:
            r = stack.pop()
            if r.id in seen:
                continue
            seen[r.id] = r
            for s in r.body():
                if s.rule is not None:
                    stack.append(s.rule)
        return [seen[k] for k in sorted(seen)]

    def expand(self) -> List[int]:
        """Reconstruct the original terminal stream (lossless check)."""
        out: List[int] = []

        def walk(rule: Rule) -> None:
            for s in rule.body():
                for _ in range(s.exp):
                    if s.rule is not None:
                        walk(s.rule)
                    else:
                        out.append(s.term)  # type: ignore[arg-type]

        walk(self.start)
        return out

    # -- serialized grammar ---------------------------------------------------

    def serialize(self) -> bytes:
        """Compact byte form.  Rules are renumbered densely; rule references
        are encoded as ``2*local_index + 1``, terminals as ``2*terminal``.

        Layout: n_rules, then per rule: n_items, (code, exp)*  (all uvarints).
        Rule 0 is the start rule.
        """
        rules = self.rules()
        local = {r.id: i for i, r in enumerate(rules)}
        vals: List[int] = [len(rules)]
        for r in rules:
            items = list(r.body())
            vals.append(len(items))
            for s in items:
                if s.rule is not None:
                    vals.append(2 * local[s.rule.id] + 1)
                else:
                    vals.append(2 * s.term)  # type: ignore[operator]
                vals.append(s.exp)
        return pack_uvarints(vals)

    # -- internals ----------------------------------------------------------

    def _new_rule(self) -> Rule:
        r = Rule(self._next_rule_id)
        self._next_rule_id += 1
        return r

    @staticmethod
    def _splice_after(left: Symbol, node: Symbol) -> None:
        right = left.next
        node.prev = left
        node.next = right
        left.next = node
        right.prev = node
        if node.rule is not None:
            node.rule.users.add(node)

    def _unlink(self, node: Symbol) -> None:
        node.prev.next = node.next
        node.next.prev = node.prev
        if node.rule is not None:
            node.rule.users.discard(node)

    # digram index maintenance -------------------------------------------------

    def _digram_key(self, left: Symbol) -> Optional[Tuple[Key, Key]]:
        right = left.next
        if left.is_guard or right.is_guard:
            return None
        return (left.key(), right.key())

    def _unindex_digram(self, left: Symbol) -> None:
        key = self._digram_key(left)
        if key is not None and self.index.get(key) is left:
            del self.index[key]

    def _scan_digram(self, left: Symbol) -> None:
        """Register the digram starting at ``left``; on a duplicate, rewrite
        per the digram-uniqueness invariant."""
        key = self._digram_key(left)
        if key is None:
            return
        match = self.index.get(key)
        if match is None:
            self.index[key] = left
            return
        if match is left or match.next is left or left.next is match:
            # same occurrence, or occurrences sharing a node (cannot rewrite)
            return
        self._handle_match(left, match)

    def _handle_match(self, new: Symbol, match: Symbol) -> None:
        # If the matched occurrence is the full body of some rule, reuse it.
        if match.prev.is_guard and match.next.next is match.prev:
            rule = match.prev.rule
            self._substitute(new, rule)
        else:
            rule = self._new_rule()
            g = rule.guard
            a = Symbol(match.term, match.rule, match.exp)
            b = Symbol(match.next.term, match.next.rule, match.next.exp)
            self._splice_after(g, a)
            self._splice_after(a, b)
            self.index[(a.key(), b.key())] = a
            # rewrite both occurrences (match first so its digrams stay valid)
            self._substitute(match, rule)
            self._substitute(new, rule)
        # rule utility: inline a rule down to a single exp-1 reference
        self._check_utility(rule)

    def _substitute(self, left: Symbol, rule: Rule) -> None:
        """Replace digram (left, left.next) by one reference to ``rule``."""
        right = left.next
        prev = left.prev
        nxt = right.next
        self._unindex_digram(prev)
        self._unindex_digram(left)
        self._unindex_digram(right)
        used = [s.rule for s in (left, right) if s.rule is not None]
        self._unlink(left)
        self._unlink(right)
        node = Symbol(None, rule, 1)
        self._splice_after(prev, node)
        node = self._merge_adjacent(node)
        self._scan_digram(node.prev)
        self._scan_digram(node)
        for r in used:
            self._check_utility(r)

    def _merge_adjacent(self, node: Symbol) -> Symbol:
        """Merge ``node`` with equal-symbol neighbours (RLE invariant)."""
        prev = node.prev
        if not prev.is_guard and prev.same_sym(node):
            self._unindex_digram(prev.prev)
            self._unindex_digram(prev)
            self._unindex_digram(node)
            prev.exp += node.exp
            self._unlink(node)
            node = prev
        nxt = node.next
        if not nxt.is_guard and nxt.same_sym(node):
            self._unindex_digram(node.prev)
            self._unindex_digram(node)
            self._unindex_digram(nxt)
            node.exp += nxt.exp
            self._unlink(nxt)
        return node

    def _check_utility(self, rule: Rule) -> None:
        if rule is self.start:
            return
        if len(rule.users) != 1:
            return
        (user,) = tuple(rule.users)
        if user.exp != 1:
            return  # still useful: one reference but repeated
        # inline: replace `user` with the rule body
        prev = user.prev
        nxt = user.next
        self._unindex_digram(prev)
        self._unindex_digram(user)
        self._unlink(user)
        body = list(rule.body())
        # detach body symbols from the dying rule and splice them in
        at = prev
        for s in body:
            # unindex body digrams keyed at the old location
            self._unindex_digram(s)
            if s.rule is not None:
                s.rule.users.discard(s)
        for s in body:
            node = Symbol(s.term, s.rule, s.exp)
            self._splice_after(at, node)
            at = node
        # re-merge at the seams and rescan digrams across the spliced range
        first = prev.next
        node = self._merge_adjacent(first)
        # walk to the end of the spliced region, merging/rescanning
        cur = node
        while cur is not nxt and not cur.is_guard:
            cur = self._merge_adjacent(cur)
            self._scan_digram(cur.prev)
            cur = cur.next
        if not nxt.is_guard or True:
            self._scan_digram(nxt.prev)


# ---------------------------------------------------------------------------
# serialized-grammar helpers (shared by inter-process merge and the reader)
# ---------------------------------------------------------------------------


def parse_grammar(buf: bytes) -> List[List[Tuple[int, int]]]:
    """Parse ``Sequitur.serialize`` output into rule lists of (code, exp)."""
    pos = 0
    n_rules, pos = read_uvarint(buf, pos)
    rules: List[List[Tuple[int, int]]] = []
    for _ in range(n_rules):
        n_items, pos = read_uvarint(buf, pos)
        items: List[Tuple[int, int]] = []
        for _ in range(n_items):
            code, pos = read_uvarint(buf, pos)
            exp, pos = read_uvarint(buf, pos)
            items.append((code, exp))
        rules.append(items)
    return rules


def serialize_grammar(rules: List[List[Tuple[int, int]]]) -> bytes:
    vals: List[int] = [len(rules)]
    for items in rules:
        vals.append(len(items))
        for code, exp in items:
            vals.append(code)
            vals.append(exp)
    return pack_uvarints(vals)


def remap_grammar(buf: bytes, terminal_map: Dict[int, int]) -> bytes:
    """Rewrite terminal ids in a serialized grammar (inter-process CST merge,
    paper Section 3.3.1)."""
    rules = parse_grammar(buf)
    out = [
        [(code if code & 1 else 2 * terminal_map[code >> 1], exp)
         for code, exp in items]
        for items in rules
    ]
    return serialize_grammar(out)


def concat_grammars(parts: List[Tuple[bytes, int]]) -> bytes:
    """Concatenate serialized grammars into one whose expansion is the
    concatenation of the parts' expansions (streaming epoch append).

    Each part is ``(serialized grammar, terminal offset)``: the part's
    terminal ids are shifted by the offset (per-epoch CSTs restart at 0, so
    epoch k's terminals live after epoch k-1's rows in the combined
    stream).  The parts' start-rule items are spliced into the combined
    start rule; their non-start rules are appended with references
    renumbered.  The result is NOT what one-shot Sequitur would induce over
    the concatenated stream -- only its expansion is guaranteed equal --
    which is exactly the value-identity the stitched readers need.
    """
    out_rules: List[List[Tuple[int, int]]] = [[]]
    for cfg, toff in parts:
        rules = parse_grammar(cfg)
        if not rules:
            continue
        base = len(out_rules)  # where this part's rules 1.. land

        def remap(code: int, base: int = base, toff: int = toff) -> int:
            if code & 1:
                return 2 * (base + (code >> 1) - 1) + 1
            return 2 * ((code >> 1) + toff)

        out_rules[0].extend((remap(c), e) for c, e in rules[0])
        for items in rules[1:]:
            out_rules.append([(remap(c), e) for c, e in items])
    return serialize_grammar(out_rules)


def expand_grammar(rules: List[List[Tuple[int, int]]]) -> Iterator[int]:
    """Yield the terminal stream of a parsed grammar (rule 0 is start).

    Iterative expansion (no recursion limit); the stream is yielded lazily so
    readers can stop early.  Stack frames are [items, item_idx, reps_left].
    """
    stack: List[List] = [[rules[0], 0, 0]]
    while stack:
        frame = stack[-1]
        items = frame[0]
        if frame[2] == 0:
            if frame[1] >= len(items):
                stack.pop()
                continue
            frame[2] = items[frame[1]][1]
            frame[1] += 1
            continue
        code = items[frame[1] - 1][0]
        frame[2] -= 1
        if code & 1:
            stack.append([rules[code >> 1], 0, 0])
        else:
            yield code >> 1


def expand_grammar_reversed(rules: List[List[Tuple[int, int]]]
                            ) -> Iterator[int]:
    """Yield the terminal stream of a parsed grammar in REVERSE order.

    Same lazy stack machine as :func:`expand_grammar`, walking rule items
    from the tail: consumers that reconstruct ancestry from a post-order
    stream (``analysis.call_chains``) can stream it without materializing
    the forward expansion first.
    """
    start = rules[0]
    stack: List[List] = [[start, len(start) - 1, 0]]
    while stack:
        frame = stack[-1]
        items = frame[0]
        if frame[2] == 0:
            if frame[1] < 0:
                stack.pop()
                continue
            frame[2] = items[frame[1]][1]
            frame[1] -= 1
            continue
        code = items[frame[1] + 1][0]
        frame[2] -= 1
        if code & 1:
            body = rules[code >> 1]
            stack.append([body, len(body) - 1, 0])
        else:
            yield code >> 1


# ---------------------------------------------------------------------------
# grammar-weighted aggregation (compressed-domain analysis support)
# ---------------------------------------------------------------------------
#
# The expansion multiplicity of every rule -- and from it the occurrence
# count of every terminal -- is a pure function of the grammar, computable in
# O(|grammar|) without expanding a single record.  TraceView builds all its
# weighted aggregates (call mixes, size histograms, byte totals, record
# counts) on these.


def _topo_order(rules: List[List[Tuple[int, int]]]) -> List[int]:
    """Rule indices ordered so every rule precedes the rules it references
    (Kahn's algorithm over the rule-reference DAG)."""
    n = len(rules)
    refs = [[code >> 1 for code, _ in items if code & 1] for items in rules]
    indeg = [0] * n
    for rs in refs:
        for c in rs:
            indeg[c] += 1
    queue = [i for i in range(n) if indeg[i] == 0]
    order: List[int] = []
    while queue:
        i = queue.pop()
        order.append(i)
        for c in refs[i]:
            indeg[c] -= 1
            if indeg[c] == 0:
                queue.append(c)
    if len(order) != n:
        raise ValueError("cyclic grammar")
    return order


def rule_weights(rules: List[List[Tuple[int, int]]]) -> List[int]:
    """How many times each rule's body is expanded in the full expansion of
    rule 0 (the start rule has weight 1; unreachable rules weight 0).

    O(|grammar|): one pass in topological order, parents before children.
    """
    w = [0] * len(rules)
    if not rules:
        return w
    w[0] = 1
    for i in _topo_order(rules):
        wi = w[i]
        if not wi:
            continue
        for code, exp in rules[i]:
            if code & 1:
                w[code >> 1] += wi * exp
    return w


def terminal_counts(rules: List[List[Tuple[int, int]]]) -> Dict[int, int]:
    """Occurrence count of every terminal in the full expansion, in
    O(|grammar|) via :func:`rule_weights` -- never by expanding."""
    w = rule_weights(rules)
    counts: Dict[int, int] = {}
    for i, items in enumerate(rules):
        wi = w[i]
        if not wi:
            continue
        for code, exp in items:
            if not code & 1:
                t = code >> 1
                counts[t] = counts.get(t, 0) + wi * exp
    return counts


def expansion_length(rules: List[List[Tuple[int, int]]]) -> int:
    """Total number of terminals in the expansion, in O(|grammar|)."""
    w = rule_weights(rules)
    return sum(w[i] * exp
               for i, items in enumerate(rules) if w[i]
               for code, exp in items if not code & 1)


def terminal_positions(rules: List[List[Tuple[int, int]]]
                       ) -> Tuple[Dict[int, int], Dict[int, int]]:
    """(first, last) 0-based expansion position of every reachable terminal.

    A bottom-up DP over rules (children before parents): each rule carries
    its expansion length plus the first/last offset of every distinct
    terminal in its subtree.  Cost is O(|grammar| x distinct terminals per
    subtree) -- bounded by |grammar| x |CST|, tiny in practice -- and never
    expands the stream.  TraceView uses the positions to decide whether a
    handle's opens all precede its data calls (exactness guard for the
    grammar-weighted per-file attribution).
    """
    n = len(rules)
    lengths = [0] * n
    firsts: List[Optional[Dict[int, int]]] = [None] * n
    lasts: List[Optional[Dict[int, int]]] = [None] * n
    for i in reversed(_topo_order(rules)):
        f: Dict[int, int] = {}
        last: Dict[int, int] = {}
        pos = 0
        for code, exp in rules[i]:
            x = code >> 1
            if code & 1:
                sz = lengths[x]
                for t, off in firsts[x].items():  # type: ignore[union-attr]
                    if t not in f:
                        f[t] = pos + off
                for t, off in lasts[x].items():  # type: ignore[union-attr]
                    last[t] = pos + (exp - 1) * sz + off
            else:
                sz = 1
                if x not in f:
                    f[x] = pos
                last[x] = pos + (exp - 1)
            pos += exp * sz
        lengths[i] = pos
        firsts[i] = f
        lasts[i] = last
    return firsts[0] or {}, lasts[0] or {}


def grammar_stats(rules: List[List[Tuple[int, int]]]) -> Dict[str, int]:
    return {
        "n_rules": len(rules),
        "n_symbols": sum(len(r) for r in rules),
        "n_terminals_expanded": None,  # expensive; computed on demand
    }
