"""PETSc-style hierarchical options database.

Capability parity with the reference's use of the PETSc options DB
(exSaddle.c:169-203, models.c option reads, abf.opts, example.yml): flat
string->string map, prefixed lookups (e.g. "saddle_fieldsplit_u_mg_levels_"),
-options_file / YAML file loading, boolean flags without values, and an
-options_left audit of unused options.
"""

import shlex


_TRUE = {"true", "yes", "1", "on"}
_FALSE = {"false", "no", "0", "off"}


def _is_value(tok):
    """A token is a value unless it looks like an option name: '-' followed
    by a letter (so negative numbers stay values)."""
    if not tok.startswith("-"):
        return True
    return not (len(tok) > 1 and (tok[1].isalpha() or tok[1] == "-"))


class Options:
    """Flat options table with PETSc lookup semantics."""

    def __init__(self, table=None):
        self.table = dict(table or {})
        self.used = set()

    # --- construction -----------------------------------------------------
    @classmethod
    def from_args(cls, args):
        """Parse a list of CLI tokens like PETSc's options parsing."""
        opts = cls()
        opts.insert_args(args)
        return opts

    def insert_args(self, args):
        i = 0
        while i < len(args):
            tok = args[i]
            if not tok.startswith("-"):
                i += 1
                continue
            name = tok.lstrip("-")
            if i + 1 < len(args) and _is_value(args[i + 1]):
                self.table[name] = args[i + 1]
                i += 2
            else:
                self.table[name] = None  # valueless flag (boolean true)
                i += 1
        # handle -options_file inserts
        if "options_file" in self.table:
            fname = self.table["options_file"]
            self.used.add("options_file")
            self.insert_file(fname)
        if "options_file_yaml" in self.table:
            fname = self.table["options_file_yaml"]
            self.used.add("options_file_yaml")
            self.insert_yaml(fname)

    def insert_file(self, fname):
        """Load a PETSc .opts file: one '-name [value]' per line, '#' comments.

        Command-line options take precedence over file options (PETSc
        semantics: the file is inserted, CLI options override)."""
        toks = []
        with open(fname) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line:
                    toks.extend(shlex.split(line))
        file_opts = Options.from_args(toks)
        for k, v in file_opts.table.items():
            self.table.setdefault(k, v)

    def insert_yaml(self, fname):
        """Load a nested YAML options file (example.yml style): nested keys
        concatenate with '_'."""
        import yaml
        with open(fname) as f:
            data = yaml.safe_load(f)

        def flatten(prefix, node):
            if isinstance(node, dict):
                for k, v in node.items():
                    flatten(f"{prefix}{k}_" if not k.endswith(":") else prefix + k,
                            v)
            else:
                key = prefix.rstrip("_")
                self.table.setdefault(key, None if node is None else str(node))

        flatten("", data or {})

    # --- typed reads ------------------------------------------------------
    def _raw(self, name, prefix=""):
        key = (prefix + name).lstrip("-")
        if key in self.table:
            self.used.add(key)
            return True, self.table[key]
        return False, None

    def has(self, name, prefix=""):
        found, _ = self._raw(name, prefix)
        return found

    def get_int(self, name, default=0, prefix=""):
        found, v = self._raw(name, prefix)
        return int(v) if found and v is not None else default

    def get_real(self, name, default=0.0, prefix=""):
        found, v = self._raw(name, prefix)
        return float(v) if found and v is not None else default

    def get_string(self, name, default=None, prefix=""):
        found, v = self._raw(name, prefix)
        return v if found else default

    def get_bool(self, name, default=False, prefix=""):
        found, v = self._raw(name, prefix)
        if not found:
            return default
        if v is None:
            return True
        lv = v.lower()
        if lv in _TRUE:
            return True
        if lv in _FALSE:
            return False
        raise ValueError(f"Unknown bool value for -{name}: {v}")

    def get_real_list(self, name, default=None, prefix=""):
        found, v = self._raw(name, prefix)
        if not found or v is None:
            return default
        return [float(t) for t in v.replace(",", " ").split()]

    # --- audit ------------------------------------------------------------
    def options_left(self):
        """Return list of (name, value) of unused options, sorted."""
        return sorted((k, v) for k, v in self.table.items()
                      if k not in self.used)

    def format_table(self):
        """Format the full option table like PETSc's -options_left output."""
        lines = ["#PETSc Option Table entries:"]
        for k in sorted(self.table):
            if k in ("options_file", "options_file_yaml"):
                continue  # PETSc consumes these before tabling
            v = self.table[k]
            lines.append(f"-{k}" if v is None else f"-{k} {v}")
        lines.append("#End of PETSc Option Table entries")
        unused = self.options_left()
        if not unused:
            lines.append("There are no unused options.")
        else:
            lines.append(f"There are {len(unused)} unused database options."
                         " They are:")
            for k, v in unused:
                lines.append(f"Option left: name:-{k}"
                             + ("" if v is None else f" value: {v}"))
        return "\n".join(lines) + "\n"
