"""Self-contained strongly-typed genetic-programming engine.

Replaces the DEAP dependency of the reference (reference grammar/gp.py
wrapped deap.gp): typed primitive sets, prefix-order derivation trees,
stack-based tree growth with optional subtree reinsertion, typed one-point
crossover, node-replacement and subtree-regrow mutations.  Selection
operators (tournament, NSGA-II/III) live in optimization/selection.py.

Trees are plain lists of immutable nodes in prefix order; `str(tree)` is a
canonical nested-call string that serves simultaneously as the fitness
cache key, the XLA compile-cache key, and the durable storage format that
`parse_tree` can re-evaluate (the analog of the reference's
`eval(grammar_string, pset.context)` — reference optimization/program.py:922
— without the arbitrary-code-execution footgun).
"""

from __future__ import annotations

import random
import re
from typing import Callable, Dict, List, Optional, Sequence

from evostencils_torch.grammar.typing import Type
from evostencils_torch.utils import profiling


class Primitive:
    __slots__ = ("name", "args", "ret", "fn")

    def __init__(self, name: str, args: Sequence[Type], ret: Type, fn: Callable):
        self.name = name
        self.args = tuple(args)
        self.ret = ret
        self.fn = fn

    @property
    def arity(self) -> int:
        return len(self.args)

    def __repr__(self):
        return f"Primitive({self.name})"


class Terminal:
    __slots__ = ("name", "ret", "value")

    def __init__(self, name: str, ret: Type, value):
        self.name = name
        self.ret = ret
        self.value = value

    arity = 0
    args = ()

    def __repr__(self):
        return f"Terminal({self.name})"


_NAME_SANITIZER = re.compile(r"[^0-9a-zA-Z_]")


def sanitize_name(name: str) -> str:
    return _NAME_SANITIZER.sub("_", name)


class PrimitiveSet:
    """Typed primitive registry.

    Types use identifier equality (grammar/typing.Type), so buckets are
    plain dicts keyed by Type — depth-aliased types share buckets
    automatically (the behavior the reference patched into DEAP at
    grammar/gp.py:55-81).
    """

    def __init__(self, name: str, ret_type: Type):
        self.name = name
        self.ret = ret_type
        self.primitives: Dict[Type, List[Primitive]] = {}
        self.terminals: Dict[Type, List[Terminal]] = {}
        self.mapping: Dict[str, object] = {}

    def _register(self, node, bucket: Dict):
        if node.name in self.mapping:
            raise ValueError(f"Duplicate grammar symbol name: {node.name}")
        self.mapping[node.name] = node
        bucket.setdefault(node.ret, []).append(node)
        # Make sure every referenced type has buckets so generation never
        # KeyErrors on a type that only appears as an argument.
        for t in getattr(node, "args", ()):  # primitives only
            self.primitives.setdefault(t, [])
            self.terminals.setdefault(t, [])
        self.primitives.setdefault(node.ret, self.primitives.get(node.ret, []))
        self.terminals.setdefault(node.ret, self.terminals.get(node.ret, []))

    def add_primitive(self, fn: Callable, arg_types: Sequence[Type], ret_type: Type, name: str):
        name = sanitize_name(name)
        if name in self.mapping:
            existing = self.mapping[name]
            # The reference registers the same production under one name for
            # several (input, output) type pairs; we disambiguate by suffix.
            suffix = 2
            while f"{name}__{suffix}" in self.mapping:
                suffix += 1
            name = f"{name}__{suffix}"
        self._register(Primitive(name, arg_types, ret_type, fn), self.primitives)

    def add_terminal(self, value, ret_type: Type, name: str):
        name = sanitize_name(name)
        if name in self.mapping:
            existing = self.mapping[name]
            if isinstance(existing, Terminal) and existing.ret == ret_type:
                return  # idempotent re-registration
            raise ValueError(f"Terminal name clash: {name}")
        self._register(Terminal(name, ret_type, value), self.terminals)

    # Aliases mirroring the reference API surface.
    addPrimitive = add_primitive
    addTerminal = add_terminal


class Tree(list):
    """Derivation tree as a prefix-order list of nodes."""

    def __init__(self, content=()):
        super().__init__(content)
        self.fitness_values: Optional[tuple] = None

    @property
    def root_type(self) -> Type:
        return self[0].ret

    def search_subtree(self, begin: int) -> slice:
        end = begin + 1
        total = self[begin].arity
        while total > 0:
            total += self[end].arity - 1
            end += 1
        return slice(begin, end)

    def copy(self) -> "Tree":
        return Tree(self)

    def invalidate(self):
        self.fitness_values = None

    def __str__(self):
        pos = [0]

        def expr() -> str:
            node = self[pos[0]]
            pos[0] += 1
            if node.arity == 0:
                return node.name
            args = [expr() for _ in range(node.arity)]
            return f"{node.name}({','.join(args)})"

        return expr()

    def __hash__(self):
        return hash(str(self))


def compile_tree(tree: Tree, pset: PrimitiveSet):
    """Evaluate the derivation tree bottom-up into its IR value."""
    pos = [0]

    def evaluate():
        node = tree[pos[0]]
        pos[0] += 1
        if isinstance(node, Terminal):
            return node.value
        args = [evaluate() for _ in range(node.arity)]
        return node.fn(*args)

    with profiling.span("compile", root=True):
        result = evaluate()
    if pos[0] != len(tree):
        raise ValueError("Malformed tree: trailing nodes")
    return result


_TOKEN = re.compile(r"[0-9a-zA-Z_]+|\(|\)|,")


def parse_tree(text: str, pset: PrimitiveSet) -> Tree:
    """Parse the canonical string form back into a Tree."""
    tokens = _TOKEN.findall(text)
    pos = [0]

    def parse() -> List:
        name = tokens[pos[0]]
        pos[0] += 1
        node = pset.mapping.get(name)
        if node is None:
            hint = ""
            base_name = name.rsplit("_", 1)[0]
            if any(k.startswith(base_name) for k in pset.mapping):
                hint = (
                    " (a production with this name exists at another depth —"
                    " was the tree evolved for a different level-hierarchy"
                    " depth than this grammar?)"
                )
            raise ValueError(f"Unknown grammar symbol {name!r}{hint}")
        nodes = [node]
        if isinstance(node, Primitive):
            if tokens[pos[0]] != "(":
                raise ValueError(f"Expected '(' after {name}")
            pos[0] += 1
            for k in range(node.arity):
                nodes.extend(parse())
                if k < node.arity - 1:
                    if tokens[pos[0]] != ",":
                        raise ValueError(f"Expected ',' in args of {name}")
                    pos[0] += 1
            if tokens[pos[0]] != ")":
                raise ValueError(f"Expected ')' closing {name}")
            pos[0] += 1
        return nodes

    result = Tree(parse())
    if pos[0] != len(tokens):
        raise ValueError("Trailing tokens in tree string")
    return result


def generate(
    pset: PrimitiveSet,
    min_height: int,
    max_height: int,
    condition: Callable[[int, int], bool],
    return_type: Optional[Type] = None,
    subtree: Optional[Sequence] = None,
    rng: random.Random = random,
) -> Tree:
    """Stack-based typed tree grower (reference grammar/gp.py:6-43).

    While the depth condition holds, both primitives and terminals may be
    drawn; beyond it only terminals (or primitives when no terminal of the
    requested type exists).  If `subtree` is given, it is spliced in at the
    first later occurrence of `return_type` (used by subtree mutation to
    optionally preserve the original material).
    """
    type_ = pset.ret if return_type is None else return_type
    expression: List = []
    height = rng.randint(min_height, max_height)
    stack = [(0, type_)]
    subtree_inserted = subtree is None
    while stack:
        depth, type_ = stack.pop()
        if not subtree_inserted and type_ == return_type and expression:
            expression.extend(subtree)
            subtree_inserted = True
            continue
        terminals = pset.terminals.get(type_, ())
        primitives = pset.primitives.get(type_, ())
        if condition(height, depth):
            nodes = list(terminals) + list(primitives)
        else:
            nodes = list(terminals) if terminals else list(primitives)
        if not nodes:
            raise RuntimeError(
                f"No terminal or primitive available for type {type_.identifier}"
            )
        choice = rng.choice(nodes)
        if choice.arity > 0:
            for arg in reversed(choice.args):
                stack.append((depth + 1, arg))
        expression.append(choice)
    return Tree(expression)


def gen_grow(
    pset: PrimitiveSet,
    min_height: int,
    max_height: int,
    type_: Optional[Type] = None,
    size_limit: int = 150,
    rng: random.Random = random,
) -> Tree:
    def condition(height, depth):
        return depth < height

    result = generate(pset, min_height, max_height, condition, type_, rng=rng)
    while len(result) > size_limit:
        result = generate(pset, min_height, max_height, condition, type_, rng=rng)
    return result


def cx_one_point(ind1: Tree, ind2: Tree, rng: random.Random = random):
    """Typed one-point crossover: swap random subtrees of matching type."""
    if len(ind1) < 2 or len(ind2) < 2:
        return ind1, ind2
    types1: Dict[Type, List[int]] = {}
    types2: Dict[Type, List[int]] = {}
    for i, node in enumerate(ind1[1:], 1):
        types1.setdefault(node.ret, []).append(i)
    for i, node in enumerate(ind2[1:], 1):
        types2.setdefault(node.ret, []).append(i)
    common = [t for t in types1 if t in types2]
    if not common:
        return ind1, ind2
    type_ = rng.choice(common)
    index1 = rng.choice(types1[type_])
    index2 = rng.choice(types2[type_])
    slice1 = ind1.search_subtree(index1)
    slice2 = ind2.search_subtree(index2)
    ind1[slice1], ind2[slice2] = ind2[slice2], ind1[slice1]
    ind1.invalidate()
    ind2.invalidate()
    return ind1, ind2


def mut_node_replacement(individual: Tree, pset: PrimitiveSet, rng: random.Random = random):
    """Swap one node for another with identical signature
    (reference grammar/gp.py:84-108)."""
    if len(individual) < 2:
        return (individual,)
    for _ in range(64):
        index = rng.randrange(1, len(individual))
        node = individual[index]
        if node.arity == 0:
            candidates = pset.terminals.get(node.ret, ())
            if candidates:
                individual[index] = rng.choice(list(candidates))
                individual.invalidate()
                return (individual,)
        else:
            candidates = [
                p
                for p in pset.primitives.get(node.ret, ())
                if p.args == node.args
            ]
            if len(candidates) > 1:
                individual[index] = rng.choice(candidates)
                individual.invalidate()
                return (individual,)
    return (individual,)


def mutate_subtree(
    individual: Tree,
    min_height: int,
    max_height: int,
    pset: PrimitiveSet,
    rng: random.Random = random,
):
    """Regrow a random subtree; with p=0.5 reuse the old subtree as seed
    (reference grammar/gp.py:111-124)."""
    index = rng.randrange(len(individual))
    node = individual[index]
    slice_ = individual.search_subtree(index)

    def condition(height, depth):
        return depth < height

    seed = list(individual[slice_]) if rng.random() < 0.5 else None
    new_subtree = generate(
        pset, min_height, max_height, condition, node.ret, seed, rng=rng
    )
    individual[slice_] = new_subtree
    individual.invalidate()
    return (individual,)


def select_unique_best(individuals: Sequence[Tree], k: int) -> List[Tree]:
    """Deduplicate by canonical string, return the k best (minimization)."""
    unique = {}
    for ind in individuals:
        unique.setdefault(str(ind), ind)
    return sorted(unique.values(), key=lambda i: i.fitness_values)[:k]
