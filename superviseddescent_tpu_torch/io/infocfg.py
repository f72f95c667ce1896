"""Minimal boost property-tree INFO config parser.

The port's own copy of ``superviseddescent_tpu/io/infocfg.py``. The
reference parses two INFO configs with boost::property_tree
(rcr-train.cpp:220-271): the model-landmarks list (rcr_training_22.cfg) and
the inter-eye-distance definition (rcr_eval.cfg).

This implements the subset of the INFO grammar those files use:
  * `key value` pairs and `key` followed by a `{ ... }` child block,
  * `;` line comments,
  * double-quoted values with spaces.

A node is a list of (key, value, children) tuples where children is itself
such a list, keeping order and duplicate keys as ptree does.
"""

from __future__ import annotations

from typing import List, Tuple

Node = List[Tuple[str, str, "Node"]]


def _tokenise(text: str):
    """Yield (token, line_number). INFO values must share the key's line, so
    line numbers are kept for the parser's lookahead."""
    for lineno, raw_line in enumerate(text.splitlines()):
        line = raw_line.split(";", 1)[0].strip()
        if not line:
            continue
        i = 0
        while i < len(line):
            c = line[i]
            if c.isspace():
                i += 1
            elif c in "{}":
                yield c, lineno
                i += 1
            elif c == '"':
                j = line.index('"', i + 1)
                yield line[i + 1:j], lineno
                i = j + 1
            else:
                j = i
                while (j < len(line) and not line[j].isspace()
                       and line[j] not in "{}"):
                    j += 1
                yield line[i:j], lineno
                i = j


def parse_info(text: str) -> Node:
    tokens = list(_tokenise(text))
    pos = 0

    def parse_block() -> Node:
        nonlocal pos
        node: Node = []
        while pos < len(tokens):
            tok, line = tokens[pos]
            if tok == "}":
                pos += 1
                return node
            key = tok
            pos += 1
            value = ""
            children: Node = []
            # a value must be on the same line as its key (INFO grammar)
            if (pos < len(tokens) and tokens[pos][0] not in "{}"
                    and tokens[pos][1] == line):
                value = tokens[pos][0]
                pos += 1
            if pos < len(tokens) and tokens[pos][0] == "{":
                pos += 1
                children = parse_block()
            node.append((key, value, children))
        return node

    return parse_block()


def get_child(node: Node, key: str) -> Tuple[str, Node]:
    """Return (value, children) of the first entry named `key`."""
    for k, v, c in node:
        if k == key:
            return v, c
    raise KeyError(key)


def read_landmarks_list_to_train(configfile) -> list:
    """Model-landmark identifiers from a training config
    (reference: rcr-train.cpp:220-244): the keys of the
    modelLandmarks.landmarks block, in order."""
    with open(configfile) as f:
        tree = parse_info(f.read())
    _, model_landmarks = get_child(tree, "modelLandmarks")
    value, children = get_child(model_landmarks, "landmarks")
    if value == "":
        return [k for k, _, _ in children]
    if value == "all":
        raise NotImplementedError(
            "Using 'all' modelLandmarks is not implemented - "
            "specify a list (matches the reference behaviour)")
    raise ValueError(
        "modelLandmarks.landmarks must be a list block or 'all'")


def read_ied_definition(evaluationfile) -> tuple:
    """(right_eye_ids, left_eye_ids) from an eval config
    (reference: rcr-train.cpp:254-271). Values are whitespace-separated
    identifier lists like "37 40"."""
    with open(evaluationfile) as f:
        tree = parse_info(f.read())
    _, ied = get_child(tree, "interEyeDistance")
    right, _ = get_child(ied, "rightEye")
    left, _ = get_child(ied, "leftEye")
    return right.split(), left.split()
