"""The port's config assembly against the JAX package's: its YAML reader
against PyYAML's ``safe_load`` on every file under ``configs/`` and on the
scalar types of YAML 1.1, and ``setup``/``update_cfg`` + ``parse_cfg``
against the JAX package's ``update_cfg`` for tubeman with each mode switch
and with CLI ``k v`` lists.  Trees compare exactly (tuples as lists)."""
import glob
import os

import pytest
import yaml

import relightableavatar_tpu.config as jconfig
from relightableavatar_tpu_torch import config as pconfig
from relightableavatar_tpu_torch.config.yaml_subset import (YamlSubsetError, load_file,
                                                            safe_load)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO)
                 for p in glob.glob(os.path.join(REPO, 'configs', '**', '*.yaml'), recursive=True))
TUBEMAN = 'configs/synthetic/tubeman.yaml'

# YAML 1.1 as PyYAML resolves it: a float needs a '.', so 5e-4 is a string
TYPED = """
lr: 5e-4
lr2: 5.0e-3
ints: [0, 7, -3, +4, 0b101, 017, 0x1F, 1_000, 1:30]
floats: [1.5, -2., .5, 1.0e+3, 6.8523015e+5, 190:20:30.15, .inf, -.Inf]
bools: [yes, No, TRUE, false, on, OFF]
nulls: [~, null, Null]
strs: [5e-4, 1e3, abc, a b, 'quoted: yes', "esc\\t\\u00e9", 'it''s', 0o17]
flow_map: {a: 1, 'b c': [1, 2], d: {e: ~}}
nested:
  deeper:
    leaf: 0.125   # a comment
  list:
  - 1
  - [2, 3]
  -
empty:
2: int key
true: bool key
multi_line_flow: [1,
    2, 3]
hash: "a # b"
"""


def _plain(node):
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    return list(node) if isinstance(node, tuple) else node


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_reader_equals_pyyaml_on_every_config(path):
    with open(os.path.join(REPO, path)) as f:
        ref = yaml.safe_load(f)
    assert load_file(os.path.join(REPO, path)) == ref


def test_there_are_48_configs():
    assert len(CONFIGS) == 48


def test_yaml_reader_types_scalars_as_pyyaml():
    ours, ref = safe_load(TYPED), yaml.safe_load(TYPED)
    assert ours == ref
    assert ours['lr'] == '5e-4' and isinstance(ours['lr2'], float)
    for key in ('ints', 'floats', 'bools', 'strs'):
        assert [type(v) for v in ours[key]] == [type(v) for v in ref[key]]


@pytest.mark.parametrize("text", ["a: &x 1\nb: *x\n", "a: |\n  text\n", "a: !!str 1\n",
                                  "a: 2001-12-14\n", "a: b\n  c\n", "<<: {a: 1}\n"],
                         ids=["anchor", "block_scalar", "tag", "timestamp",
                              "multi_line_plain", "merge_key"])
def test_yaml_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(YamlSubsetError):
        safe_load(text)


def _jax_cfg(argv):
    cfg = jconfig.default_cfg()
    jconfig.update_cfg(cfg, jconfig.make_parser().parse_args(argv))
    return cfg


@pytest.mark.parametrize("opts", [
    [], ['relighting', 'True'], ['vis_novel_light', 'True', 'relighting', 'True'],
    ['vis_pose_sequence', 'True'], ['vis_novel_view', 'True'], ['vis_sphere_tracing', 'True'],
    ['vis_novel_view', 'True', 'relighting', 'True'],
    ['vis_can_mesh', 'True'],
    ['relighting', 'True', 'ratio', '0.5', 'H', '64', 'train.lr', '1e-3',
     'test.frame_sampler_interval', '1', 'vis_ext', '.hdr', 'tpu.knn_impl', 'pallas'],
    ['relighting_cfg', "{'n_samples': 5}", 'relighting', 'True', 'test_view', '[0, 2]',
     'vis_ground_shading', 'True', 'cond_dim', '12'],
], ids=["plain", "relighting", "novel_light", "pose_sequence", "novel_view",
        "sphere_tracing", "novel_view_relight", "mesh", "k_v_list", "k_v_overlay"])
def test_setup_matches_jax_update_cfg(opts):
    argv = ['-c', TUBEMAN, '-t', 'evaluate', *opts]
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        ours, _ = pconfig.setup(argv)
        ref = _jax_cfg(argv)
    finally:
        os.chdir(cwd)
    assert _plain(ours) == _plain(ref)


def test_parse_cfg_derives_folders_and_refuses_unknown_knn():
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        cfg, args = pconfig.setup(['-c', TUBEMAN, '-t', 'network', 'relighting', 'True',
                                   'trained_model_dir', 'm', 'result_dir', 'r'])
        assert args.type == 'network'
        assert cfg.trained_model_dir == os.path.join('m', 'relight', 'tubeman_relight')
        assert cfg.result_dir == os.path.join('r', 'relight', 'tubeman_relight')
        assert cfg.vis_rendering_map is True and cfg.cond_dim == cfg.n_bones * 3
        with pytest.raises(ValueError, match="knn_impl"):
            pconfig.setup(['-c', TUBEMAN, '-t', 'network', 'tpu.knn_impl', 'grouped'])
    finally:
        os.chdir(cwd)
