"""What the JAX package's root experiment scripts say in their source, for
the port's tests: a script that runs its plan at import cannot be imported
to read its flags."""

import ast


def literal_flags(path):
    """The literal keyword values of each FLAGS.override / FLAGS.scope call
    in a script's source, a dict a call in source order (a value built from
    a variable, such as a path, left out; calls left empty dropped)."""
    with open(path) as fin:
        tree = ast.parse(fin.read())
    calls = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in ('override', 'scope')
                and getattr(node.func.value, 'id', None) == 'FLAGS'):
            flags = {}
            for kw in node.keywords:
                try:
                    flags[kw.arg] = eval(compile(ast.Expression(kw.value), path, 'eval'), {})
                except NameError:
                    continue
            if flags:
                calls.append((node.lineno, flags))
    return [flags for _, flags in sorted(calls, key=lambda c: c[0])]
