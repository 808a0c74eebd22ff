"""Headless Streamlit harness: run the planner and research apps without
streamlit.

A copy of ``maunet_tpu/apps/headless.py`` for the port's two apps.  Where
streamlit is not installed (the CPU test hosts, the GPU host),
``apps/planner.py`` and ``apps/research.py`` would otherwise be wiring whose
API typos only surface where streamlit is.

``FakeStreamlit`` implements exactly the ``st.*`` surface the two apps use —
no catch-all ``__getattr__`` — so a misspelled or stale API call raises
``AttributeError``.  Widget values are scripted by label; every render call
is recorded for assertions (``st.components.v1.html`` as
``components_html``).  ``run_planner`` injects the fake (and a fake
drawable canvas) into ``sys.modules`` and drives the real ``main()``;
``run_research_page`` drives one research page, or the page router.

Also a smoke command, on the card unless asked otherwise:

    python -m maunet_tpu_torch.apps.headless planner --models-dir models [--device cpu]
    python -m maunet_tpu_torch.apps.headless research --reports-dir R --data-dir D
        [--checkpoint CKPT.pth] [--device cpu]

``research`` renders every page; with ``--checkpoint`` the model browser
loads it and predicts the first test sample of ``--data-dir``.
"""

from __future__ import annotations

import contextlib
import sys
import types
from dataclasses import dataclass, field
from typing import Any


class StopRendering(Exception):
    """Raised by st.stop() — ends the script run like streamlit does."""


class _SessionState:
    """Attribute + item access, ``in`` support — like st.session_state."""

    def __init__(self):
        object.__setattr__(self, "_d", {})

    def __contains__(self, k):
        return k in self._d

    def __getattr__(self, k):
        try:
            return object.__getattribute__(self, "_d")[k]
        except KeyError:
            raise AttributeError(k) from None

    def __setattr__(self, k, v):
        self._d[k] = v

    def __getitem__(self, k):
        return self._d[k]

    def __setitem__(self, k, v):
        self._d[k] = v


@dataclass
class _Widgets:
    """Scripted widget answers, shared across st / sidebar / columns."""

    answers: dict[str, Any] = field(default_factory=dict)

    def get(self, label, default):
        return self.answers.get(label, default)


class _Container:
    """One render surface (the page body, the sidebar, a column, an
    expander).  Records every call as (container, method, args, kwargs) on
    the shared log and answers input widgets from the shared script."""

    def __init__(self, widgets: _Widgets, calls: list, name: str = "main"):
        self._w = widgets
        self.calls = calls
        self._name = name

    # -- structure ---------------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _rec(self, method, *args, **kwargs):
        self.calls.append((self._name, method, args, kwargs))

    def columns(self, spec):
        n = spec if isinstance(spec, int) else len(spec)
        self._rec("columns", n)
        return [_Container(self._w, self.calls, f"{self._name}.col{i}")
                for i in range(n)]

    def expander(self, label, expanded=False):
        self._rec("expander", label)
        return _Container(self._w, self.calls, f"{self._name}.expander")

    def spinner(self, text=""):
        self._rec("spinner", text)
        return contextlib.nullcontext()

    # -- display -----------------------------------------------------------
    def _display(method):  # noqa: N805 — tiny local factory
        def f(self, *args, **kwargs):
            self._rec(method, args[0] if args else None, **kwargs)
        f.__name__ = method
        return f

    title = _display("title")
    header = _display("header")
    subheader = _display("subheader")
    markdown = _display("markdown")
    text = _display("text")
    json = _display("json")
    info = _display("info")
    warning = _display("warning")
    error = _display("error")
    image = _display("image")
    pyplot = _display("pyplot")
    dataframe = _display("dataframe")
    bar_chart = _display("bar_chart")
    line_chart = _display("line_chart")
    map = _display("map")
    del _display

    def metric(self, label, value, delta=None):
        self._rec("metric", (label, value, delta))

    # -- inputs ------------------------------------------------------------
    def text_input(self, label, value="", **kw):
        self._rec("text_input", label)
        return self._w.get(label, value)

    def number_input(self, label, min_value=None, max_value=None, value=None,
                     step=None, **kw):
        self._rec("number_input", label)
        return self._w.get(label, value if value is not None else min_value)

    def slider(self, label, min_value=None, max_value=None, value=None, **kw):
        self._rec("slider", label)
        return self._w.get(label, value if value is not None else min_value)

    def selectbox(self, label, options, index=0, **kw):
        self._rec("selectbox", label)
        options = list(options)
        default = options[index] if options else None
        return self._w.get(label, default)

    def multiselect(self, label, options, default=None, **kw):
        self._rec("multiselect", label)
        return list(self._w.get(label, default if default is not None else []))

    def radio(self, label, options, index=0, horizontal=False,
              format_func=None, **kw):
        self._rec("radio", label)
        options = list(options)
        if format_func is not None:  # must be callable on every option
            for o in options:
                format_func(o)
        default = options[index] if options else None
        return self._w.get(label, default)

    def button(self, label, type="secondary", **kw):
        self._rec("button", label)
        return bool(self._w.get(label, False))


class FakeStreamlit(_Container):
    """The module-level ``st`` object: a page container plus the module-only
    APIs (set_page_config, session_state, sidebar, cache_resource, stop)."""

    def __init__(self, answers: dict[str, Any] | None = None):
        super().__init__(_Widgets(dict(answers or {})), calls=[], name="main")
        self.session_state = _SessionState()
        self.sidebar = _Container(self._w, self.calls, "sidebar")
        # st.components.v1.html: the research app's interactive diagram
        self.components = types.SimpleNamespace(v1=types.SimpleNamespace(
            html=lambda body, height=None, **kw:
                self._rec("components_html", body, height=height)))

    def set_page_config(self, **kw):
        self._rec("set_page_config", kw.get("page_title"))

    def cache_resource(self, fn=None, **kw):
        if fn is None:  # used as @st.cache_resource(...)
            return lambda f: f
        return fn

    def stop(self):
        raise StopRendering()

    # convenience for assertions -------------------------------------------
    def rendered(self, method: str) -> list:
        return [args[0] if args else None
                for (_, m, args, _k) in self.calls if m == method]


@contextlib.contextmanager
def _patched_modules(st: FakeStreamlit, canvas_rgba=None):
    """Install the fake ``streamlit`` and a fake drawable canvas into
    sys.modules for the duration of one app run."""
    saved = {k: sys.modules.get(k)
             for k in ("streamlit", "streamlit_drawable_canvas")}
    mod = types.ModuleType("streamlit")
    for name in dir(st):
        if not name.startswith("_"):
            setattr(mod, name, getattr(st, name))
    mod.session_state = st.session_state
    mod.sidebar = st.sidebar
    sys.modules["streamlit"] = mod

    canvas_mod = types.ModuleType("streamlit_drawable_canvas")

    def st_canvas(**kw):
        st.calls.append(("main", "st_canvas", (kw.get("key"),), {}))
        return types.SimpleNamespace(image_data=canvas_rgba)

    canvas_mod.st_canvas = st_canvas
    sys.modules["streamlit_drawable_canvas"] = canvas_mod
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def run_planner(argv: list[str], answers: dict[str, Any] | None = None,
                canvas_rgba=None) -> FakeStreamlit:
    """Execute apps/planner.py main() headlessly.  ``argv`` is the app's CLI
    tail (e.g. ["--models-dir", d, "--img-size", "32", "--device", "cpu"])."""
    from maunet_tpu_torch.apps import planner

    st = FakeStreamlit(answers)
    old_argv = sys.argv
    sys.argv = ["planner.py"] + list(argv)
    try:
        with _patched_modules(st, canvas_rgba):
            try:
                planner.main()
            except StopRendering:
                pass
    finally:
        sys.argv = old_argv
    return st


def run_research_page(page: str, argv: list[str],
                      answers: dict[str, Any] | None = None) -> FakeStreamlit:
    """Execute one apps/research.py page headlessly; ``page`` is a key of
    ``research.PAGES``, or "main" to drive the page router.  ``argv`` is the
    app's CLI tail (e.g. ["--data-dir", d, "--device", "cpu"])."""
    from maunet_tpu_torch.apps import research

    st = FakeStreamlit(answers)
    old_argv = sys.argv
    sys.argv = ["research.py"] + list(argv)
    try:
        with _patched_modules(st):
            try:
                if page == "main":
                    research.main()
                else:
                    research.PAGES[page](st, research._args())
            except StopRendering:
                pass
    finally:
        sys.argv = old_argv
    return st


def main(argv: list[str]) -> int:
    app, tail = (argv[0], argv[1:]) if argv else ("planner", [])
    if app == "planner":
        fake = run_planner(tail, answers={"Run Prediction": True})
        print(f"{app}: {len(fake.calls)} render calls, no AttributeErrors")
        return 0
    if app != "research":
        print(f"headless: no app {app!r} (planner or research)", file=sys.stderr)
        return 2
    import argparse

    from maunet_tpu_torch.apps import research

    p = argparse.ArgumentParser(prog="headless research")
    p.add_argument("--checkpoint", default=None,
                   help="a .pth for the model browser, which then predicts a test sample")
    known, tail = p.parse_known_args(tail)
    answers = {}
    if known.checkpoint:
        answers = {"Checkpoint path (.pth or orbax dir)": known.checkpoint,
                   "Predict a test sample (zoomed quadrants)": True}
    for name in research.PAGES:
        fake = run_research_page(name, tail, answers)
        print(f"-- page {name}: {len(fake.calls)} render calls, no AttributeErrors")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
