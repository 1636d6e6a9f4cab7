"""The port's CLI takes ``main.py``'s defaults: with no ``--scene`` it
renders the staircase (ROADMAP C-22), and every flag ``main.py`` has
parses to the same default."""

from unittest import mock

import pytest

import main as jmain
from tpu_pathtracer_torch import __main__ as cli


class _Parsed(Exception):
    pass


def _jax_defaults():
    """main.py's parsed defaults, caught before it builds a scene."""
    def stop(args):
        raise _Parsed(vars(args))
    with mock.patch.object(jmain, "build", stop), \
            pytest.raises(_Parsed) as got:
        jmain.main([])
    return got.value.args[0]


def test_default_scene_is_the_staircase():
    assert cli.make_parser().parse_args([]).scene == "staircase"


def test_defaults_equal_main_py():
    ours = vars(cli.make_parser().parse_args([]))
    theirs = _jax_defaults()
    assert set(ours) - set(theirs) == {"device"}
    assert {k: ours[k] for k in theirs} == theirs
