"""Live options panel for plplay (reference: demos/settings.c — the
1210-LoC Nuklear GUI that drives every pl_options knob during playback).

The port's panel is a terminal (curses) one, as the JAX package's:
every option from the reflection table (core/options.py, all reference
keys) is browsable, filterable and editable LIVE during playback — the
next rendered vsync picks the new value up because plplay reads
`opts.params` per vsync, and the Renderer's plan cache keys on
`RenderParams.key()`, so a changed option plans afresh while unchanged
configs keep their cached plans (the same "tweak a slider mid-playback"
loop settings.c implements with pass-cache invalidation).

Split in two layers so the state machine is testable without a TTY:

  SettingsPanel   pure logic: cursor, filter, edit buffer, cycling,
                  preset application, status/error reporting.  Every
                  mutation goes through Options.set -> full validation
                  and range clamping (OptionError surfaces in the
                  status line instead of crashing playback).
  run_curses      the thin curses front-end: draws the list + playback
                  stats, maps keys, never holds the render loop hostage
                  (non-blocking getch; rendering continues between
                  keystrokes).

Keys: Up/Down/PgUp/PgDn move - Space/Right cycle bools+enums forward
(Left backward) - +/- step numbers - Enter edit (Enter apply, Esc
cancel) - / filter - p cycle preset - d reset option to default -
s show the pl_options_save string - q quit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..core.options import OPTION_TABLE, OptionError, Options, find_option

PRESETS = ("default", "fast", "high_quality")

# numeric step = range/50 for bounded floats (settings.c sliders use
# the same granularity idea), 1 for ints/unbounded
def _step(opt) -> float:
    if opt.type == "int":
        return 1
    if opt.minimum != opt.maximum:
        return (opt.maximum - opt.minimum) / 50.0
    return 0.1


@dataclass
class SettingsPanel:
    """Headless state machine of the live options panel."""
    options: Options
    cursor: int = 0
    scroll: int = 0
    filter: str = ""
    editing: bool = False
    edit_buf: str = ""
    filtering: bool = False
    status: str = "live options - / to filter, q to quit panel"
    preset: str = "default"
    _defaults: Options = field(default_factory=Options)

    # -- view ----------------------------------------------------------

    def visible(self) -> List[Tuple[str, str, bool]]:
        """(key, display value, is_default) rows under the filter."""
        rows = []
        for opt in OPTION_TABLE():
            if opt.type == "preset":
                continue
            if self.filter and self.filter.lower() not in opt.key.lower():
                continue
            cur = self.options.get(opt.key)
            dfl = self._defaults.get(opt.key)
            rows.append((opt.key, self._fmt(cur), cur == dfl))
        return rows

    @staticmethod
    def _fmt(v) -> str:
        if isinstance(v, bool):
            return "yes" if v else "no"
        if isinstance(v, float):
            return f"{v:g}"
        if v is None:
            return "none"
        return str(v)

    def current_key(self) -> Optional[str]:
        rows = self.visible()
        if not rows:
            return None
        self.cursor = max(0, min(self.cursor, len(rows) - 1))
        return rows[self.cursor][0]

    def describe(self) -> str:
        key = self.current_key()
        if key is None:
            return ""
        opt = find_option(key)
        parts = [opt.type]
        if opt.minimum != opt.maximum:
            parts.append(f"[{opt.minimum:g}, {opt.maximum:g}]")
        if opt.choices:
            parts.append("{" + ", ".join(opt.choices) + "}")
        if opt.description:
            parts.append(opt.description)
        return " ".join(parts)

    # -- navigation ------------------------------------------------------

    def move(self, delta: int):
        n = len(self.visible())
        if n:
            self.cursor = max(0, min(self.cursor + delta, n - 1))

    # -- mutation --------------------------------------------------------

    def _set(self, key: str, value: str):
        try:
            self.options.set(key, value)
            self.status = f"{key} = {self._fmt(self.options.get(key))}"
        except OptionError as e:
            # user errors surface in the status line, never crash the
            # playback loop (the honest-degradation rule)
            self.status = f"error: {e}"

    def cycle(self, delta: int = 1):
        """Space/arrows on bools + enums: step through the choices."""
        key = self.current_key()
        if key is None:
            return
        opt = find_option(key)
        cur = self.options.get(key)
        if opt.type == "bool":
            self._set(key, "no" if cur else "yes")
        elif opt.choices:
            vals = list(opt.choices)
            cur_s = self._fmt(cur)
            i = vals.index(cur_s) if cur_s in vals else -delta
            self._set(key, vals[(i + delta) % len(vals)])
        elif opt.type in ("int", "float"):
            self.nudge(delta)
        else:
            self.status = f"{key}: press Enter to edit"

    def nudge(self, delta: int):
        """+/- on numeric options: one slider step, range-clamped by
        Options.set."""
        key = self.current_key()
        if key is None:
            return
        opt = find_option(key)
        if opt.type not in ("int", "float"):
            return self.cycle(delta)
        cur = self.options.get(key)
        if not isinstance(cur, (int, float)) or isinstance(cur, bool):
            # unset value: step from the type's zero (`cur or 0` would
            # also coerce a 0.0 float to int 0 and truncate the step)
            cur = 0.0 if opt.type == "float" else 0
        new = cur + delta * _step(opt)
        if opt.type == "int":
            new = int(round(new))
        self._set(key, self._fmt(new))

    def reset_current(self):
        key = self.current_key()
        if key is None:
            return
        self._set(key, self._fmt(self._defaults.get(key)))

    def cycle_preset(self):
        self.preset = PRESETS[(PRESETS.index(self.preset) + 1)
                              % len(PRESETS)]
        try:
            self.options.set("preset", self.preset)
            self.status = f"preset = {self.preset}"
        except OptionError as e:
            self.status = f"error: {e}"

    # -- edit mode ---------------------------------------------------------

    def start_edit(self):
        key = self.current_key()
        if key is None:
            return
        self.editing = True
        self.edit_buf = self._fmt(self.options.get(key))

    def edit_char(self, ch: str):
        if ch == "\x7f":                       # backspace
            self.edit_buf = self.edit_buf[:-1]
        else:
            self.edit_buf += ch

    def commit_edit(self):
        key = self.current_key()
        self.editing = False
        if key is not None:
            self._set(key, self.edit_buf)

    def cancel_edit(self):
        self.editing = False
        self.status = "edit cancelled"

    # -- filter mode ------------------------------------------------------

    def start_filter(self):
        self.filtering = True
        self.filter = ""

    def filter_char(self, ch: str):
        if ch == "\x7f":
            self.filter = self.filter[:-1]
        else:
            self.filter += ch
        self.cursor = 0

    def end_filter(self):
        self.filtering = False
        n = len(self.visible())
        self.status = f"filter {self.filter!r}: {n} options"

    def show_save(self):
        s = self.options.save()
        self.status = ("--options \"" + s + "\"") if s else "(defaults)"

    # -- key dispatch (shared by the curses front-end and tests) ----------

    def handle_key(self, key: str) -> bool:
        """Returns False when the panel should close."""
        if self.editing:
            if key == "\n":
                self.commit_edit()
            elif key == "\x1b":
                self.cancel_edit()
            elif len(key) == 1:
                self.edit_char(key)
            return True
        if self.filtering:
            if key in ("\n", "\x1b"):
                self.end_filter()
            elif len(key) == 1:
                self.filter_char(key)
            return True
        if key == "q":
            return False
        if key == "UP":
            self.move(-1)
        elif key == "DOWN":
            self.move(+1)
        elif key == "PGUP":
            self.move(-10)
        elif key == "PGDN":
            self.move(+10)
        elif key in (" ", "RIGHT"):
            self.cycle(+1)
        elif key == "LEFT":
            self.cycle(-1)
        elif key == "+":
            self.nudge(+1)
        elif key == "-":
            self.nudge(-1)
        elif key == "\n":
            self.start_edit()
        elif key == "/":
            self.start_filter()
        elif key == "p":
            self.cycle_preset()
        elif key == "d":
            self.reset_current()
        elif key == "s":
            self.show_save()
        return True


def run_curses(panel: SettingsPanel, tick) -> None:
    """Curses front-end.  `tick()` advances playback by one vsync and
    returns a stats string (or None at EOF).  The panel never blocks
    rendering: keys are polled with a timeout between vsyncs."""
    import curses

    def _main(scr):
        curses.curs_set(0)
        scr.timeout(0)                 # non-blocking getch
        stats = ""
        running = True
        while running:
            s = tick()
            if s is None:
                break
            stats = s
            # drain pending keys
            while True:
                c = scr.getch()
                if c == -1:
                    break
                key = {curses.KEY_UP: "UP", curses.KEY_DOWN: "DOWN",
                       curses.KEY_LEFT: "LEFT", curses.KEY_RIGHT: "RIGHT",
                       curses.KEY_PPAGE: "PGUP", curses.KEY_NPAGE: "PGDN",
                       curses.KEY_ENTER: "\n",
                       curses.KEY_BACKSPACE: "\x7f"}.get(c)
                if key is None and 0 <= c < 256:
                    key = chr(c)
                if key is not None and not panel.handle_key(key):
                    running = False
            _draw(scr, panel, stats)

    def _draw(scr, panel, stats):
        import curses
        h, w = scr.getmaxyx()
        scr.erase()
        scr.addnstr(0, 0, stats, w - 1, curses.A_BOLD)
        mode = ("EDIT: " + panel.edit_buf if panel.editing else
                "FILTER: " + panel.filter if panel.filtering else
                panel.status)
        scr.addnstr(1, 0, mode, w - 1)
        scr.addnstr(2, 0, panel.describe(), w - 1, curses.A_DIM)
        rows = panel.visible()
        view_h = h - 4
        if panel.cursor < panel.scroll:
            panel.scroll = panel.cursor
        if panel.cursor >= panel.scroll + view_h:
            panel.scroll = panel.cursor - view_h + 1
        for i, (key, val, is_dfl) in enumerate(
                rows[panel.scroll:panel.scroll + view_h]):
            attr = curses.A_REVERSE if i + panel.scroll == panel.cursor \
                else (curses.A_NORMAL if is_dfl else curses.A_BOLD)
            scr.addnstr(3 + i, 0, f"{key:36s} {val}", w - 1, attr)
        scr.refresh()

    import curses
    curses.wrapper(_main)
