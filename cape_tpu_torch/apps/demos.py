"""Demo / evaluation suite.

Counterpart of `cape_tpu.apps.demos` over the PyTorch engine, method for
method. Its random draws are the JAX package's: test_model samples z with
seed 0 through the engine's row-keyed sampler (`core.prng`), the GMM
draws go through `models.gmm.GMM.sample` with a `core.prng` key, and the
N(0, I) draws come from the same numpy Generator.

Parity with the reference's demos.py:
  * test_model        — autoencoding eval on the test split, per-vertex
                        Euclidean error (mm) over the 3627 clothing
                        vertices, mean/std/median, appended results txt
                        (demos.py:47-124);
  * sample_vary_pose  — fixed clothing type, per demo pose sample the
                        latent N times, pose via SMPL LBS, export .obj
                        (demos.py:127-169);
  * sample_vary_clotype — fixed pose, 4 clothing types (demos.py:172-222);
  * sample_gmm_prior  — latent draws from the pretrained GMM prior
                        (BASELINE config #5; asset data/pretrained_gmm.pkl);
  * SimpleDemo        — the no-SMPL clotype demo (run_simple_demo.py).

Reposing uses the torch SMPL LBS (smpl.lbs) when an SMPL model file is
available; otherwise unposed (canonical-pose) meshes are
exported with a notice — the model files are license-gated and not
shipped.
"""

from __future__ import annotations

import os
from os.path import join

import numpy as np

from cape_tpu_torch.apps.inference import InferenceEngine
from cape_tpu_torch.core import prng
from cape_tpu_torch.meshops import assets
from cape_tpu_torch.meshops.obj_io import save_obj
from cape_tpu_torch.smpl.joints import filter_cloth_pose
from cape_tpu_torch.smpl.lbs import SMPLModel, lbs
from cape_tpu_torch.smpl.rodrigues import rotmats_to_pose

CLO_TYPES = np.array(["shortlong", "shortshort", "longshort", "longlong"])


class DemoSuite:
    def __init__(
        self,
        engine: InferenceEngine,
        name: str,
        dataset: str = "dataset_male_4clotypes",
        gender: str = "male",
        n_sample: int = 5,
        save_objs: bool = True,
        smpl_model_folder: str = "body_models",
        results_root: str = "results",
        seed: int = 123,
        vis: bool = False,
    ):
        self.engine = engine
        self.name = name
        self.dataset = dataset
        self.n_sample = n_sample
        self.save_objs = save_objs
        # vis_demo flag (reference config_parser.py:59): instead of the
        # reference's interactive MeshViewers grid (demos.py:225-246) we
        # write offscreen-rendered PNG contact sheets AND a self-contained
        # interactive HTML viewer (meshops.viewer) next to the .objs
        self.vis = vis
        self.rng = np.random.default_rng(seed)

        self.clothing_verts_idx = assets.clothing_verts_idx()
        verts, faces = assets.template_mesh()
        self.minimal_shape = verts
        self.faces = faces

        poses = assets.demo_pose_params()
        self.demo_rot = poses["rot"]          # [6, 216]
        self.demo_pose = poses["pose"]        # [6, 72]
        self.train_mean, self.train_std = assets.trainset_stats()

        self.results_dir = join(results_root, name)
        os.makedirs(self.results_dir, exist_ok=True)

        try:
            self.smpl = SMPLModel.load(smpl_model_folder, gender).to(engine.device)
        except (FileNotFoundError, OSError):
            self.smpl = None
            print(
                "note: no SMPL model file found — demo meshes are exported "
                "in canonical pose (reposing skipped)",
                flush=True,
            )

    # ------------------------------------------------------------------
    def test_model(self, bodydata, stats_from_data: bool = True) -> dict:
        """Autoencoding eval on the test split (reference demos.py:47-124)."""
        disp, pose, clo = bodydata.split("test")
        # seed 0: the JAX suite's PRNGKey(0), whose last word its engine takes
        pred = self.engine.autoencode(disp, pose, clo, rng=0, sample=True)
        mean = bodydata.mean if stats_from_data else self.train_mean
        std = bodydata.std if stats_from_data else self.train_std
        pred_mm = pred * std + mean
        gt_mm = disp * std + mean

        diff = (pred_mm - gt_mm)[:, self.clothing_verts_idx, :]
        err = np.sqrt(np.sum(diff**2, axis=2))
        result = {
            "euclidean_mean_m": float(np.mean(err)),
            "euclidean_std_m": float(np.std(err)),
            "euclidean_median_m": float(np.median(err)),
            "n_test": len(disp),
        }
        txt = (
            f"\nResults from {self.name}:\n"
            f"Euclidean err mean {result['euclidean_mean_m']:.5f}, "
            f"std {result['euclidean_std_m']:.5f}, "
            f"median {result['euclidean_median_m']:.5f} "
            f"({result['n_test']} test frames)\n"
        )
        print(txt, flush=True)
        for path in (
            join(self.results_dir, f"test_results_{self.dataset}.txt"),
            join(self.results_dir, "..", f"all_test_results_{self.dataset}.txt"),
        ):
            with open(path, "a+") as fp:
                fp.write(txt)

        if self.save_objs and len(disp) > 0:
            obj_dir = join(self.results_dir, f"test_reconstruction_objs_{self.dataset}")
            step = max(len(disp) // max(self.n_sample, 1), 1)
            sel = np.arange(len(disp))[::step][: self.n_sample]
            full = self._disp_to_fullbody(pred_mm[sel])
            pose_full = getattr(bodydata, "pose_test_full", None)
            if pose_full is not None and pose_full.shape[-1] == 216:
                pose_aa = rotmats_to_pose(pose_full[sel])
            elif pose_full is not None and pose_full.shape[-1] == 72:
                pose_aa = pose_full[sel]
            else:
                pose_aa = None
            self._export(full, pose_aa, obj_dir, prefix="recon")
        return result

    # ------------------------------------------------------------------
    def _demo_conditions(self) -> np.ndarray:
        """Clothing-joint pose conditions for the 6 demo poses, matching the
        model's pose_type (126-d rot matrices or 42-d axis-angle)."""
        src = (
            self.demo_rot
            if self.engine.model.cfg.cond_dim % 9 == 0
            else self.demo_pose
        )
        return filter_cloth_pose(src)

    def sample_vary_pose(self):
        """Fixed clothing type, vary pose, n_sample z draws per pose
        (reference demos.py:127-169)."""
        rot = self._demo_conditions()
        V = len(self.minimal_shape)
        if self.n_sample <= 0:
            return np.zeros((len(rot), 0, V, 3), np.float32)
        clotype = (CLO_TYPES == "shortlong").astype(np.float32)
        clotype_rep = np.repeat(clotype[None], len(rot), axis=0)
        pose_emb, clotype_emb = self.engine.encode_only_condition(rot, clotype_rep)
        clotype_emb = clotype_emb[:1]

        obj_dir = join(self.results_dir, "sample_vary_pose")
        z = self.rng.normal(size=(self.n_sample, self.engine.model.cfg.nz)).astype(np.float32)
        outputs = []
        for idx in range(len(rot)):
            y = pose_emb[idx : idx + 1]
            z_total = np.concatenate(
                [z, np.repeat(y, self.n_sample, 0), np.repeat(clotype_emb, self.n_sample, 0)],
                axis=-1,
            )
            disp = self.engine.decode(z_total, y, clotype_emb)
            full = self._disp_to_fullbody(disp * self.train_std + self.train_mean)
            pose_aa = np.repeat(self.demo_pose[idx : idx + 1], self.n_sample, axis=0)
            self._export(full, pose_aa, obj_dir, prefix=f"pose{idx}")
            outputs.append(full)
        return np.stack(outputs)

    # ------------------------------------------------------------------
    def sample_vary_clotype(self):
        """Fixed pose, 4 clothing types, n_sample z draws per type
        (reference demos.py:172-222)."""
        clotype = np.eye(4, dtype=np.float32)
        if self.n_sample <= 0:
            return np.zeros((len(clotype), 0, len(self.minimal_shape), 3), np.float32)
        rot = self._demo_conditions()[0:1]
        rot_rep = np.repeat(rot, len(clotype), axis=0)
        pose_emb, clotype_emb = self.engine.encode_only_condition(rot_rep, clotype)
        pose_emb = pose_emb[:1]

        obj_dir = join(self.results_dir, "sample_vary_clotype")
        z = self.rng.normal(size=(self.n_sample, self.engine.model.cfg.nz)).astype(np.float32)
        outputs = []
        for i, name in enumerate(CLO_TYPES):
            y2 = clotype_emb[i : i + 1]
            z_total = np.concatenate(
                [z, np.repeat(pose_emb, self.n_sample, 0), np.repeat(y2, self.n_sample, 0)],
                axis=-1,
            )
            disp = self.engine.decode(z_total, pose_emb, y2)
            full = self._disp_to_fullbody(disp * self.train_std + self.train_mean)
            pose_aa = np.repeat(self.demo_pose[2:3], self.n_sample, axis=0)
            self._export(full, pose_aa, obj_dir, prefix=f"clotype_{name}")
            outputs.append(full)
        return np.stack(outputs)

    # ------------------------------------------------------------------
    def sample_gmm_prior(self, n: int | None = None):
        """Latent draws from the pretrained GMM prior instead of N(0, I)
        (asset data/pretrained_gmm.pkl; 18-dim — requires nz == 18)."""
        from cape_tpu_torch.models.gmm import GMM

        gmm = GMM.load_pretrained()
        nz = self.engine.model.cfg.nz
        if gmm.means.shape[1] != nz:
            raise ValueError(
                f"pretrained GMM is {gmm.means.shape[1]}-dim but model nz={nz}"
            )
        n = n or self.n_sample
        if n <= 0:
            return np.zeros((0, len(self.minimal_shape), 3), np.float32)
        z = gmm.sample(prng.PRNGKey(int(self.rng.integers(1 << 30))), n)

        rot = self._demo_conditions()[0:1]
        clotype = (CLO_TYPES == "shortlong").astype(np.float32)[None]
        pose_emb, clotype_emb = self.engine.encode_only_condition(rot, clotype)
        z_total = np.concatenate(
            [z, np.repeat(pose_emb, n, 0), np.repeat(clotype_emb, n, 0)], axis=-1
        )
        disp = self.engine.decode(z_total, pose_emb, clotype_emb)
        full = self._disp_to_fullbody(disp * self.train_std + self.train_mean)
        pose_aa = np.repeat(self.demo_pose[0:1], n, axis=0)
        self._export(full, pose_aa, join(self.results_dir, "sample_gmm_prior"), prefix="gmm")
        return full

    # ------------------------------------------------------------------
    def sample_gmm_sweep(self, n: int | None = None, gmm=None):
        """Pose-dependent clothing sampling sweep: for every demo pose and
        clothing type, draw latents from the GMM prior instead of N(0, I)
        (BASELINE config #5's generation sweep). Returns
        [n_pose, n_clotype, n, V, 3] full bodies and exports objs."""
        from cape_tpu_torch.models.gmm import GMM

        gmm = gmm or GMM.load_pretrained()
        nz = self.engine.model.cfg.nz
        if gmm.means.shape[1] != nz:
            raise ValueError(
                f"GMM prior is {gmm.means.shape[1]}-dim but model nz={nz}"
            )
        n = n or self.n_sample
        conds = self._demo_conditions()
        clotypes = np.eye(4, dtype=np.float32)
        if n <= 0:
            return np.zeros(
                (len(conds), len(clotypes), 0, len(self.minimal_shape), 3), np.float32
            )
        obj_dir = join(self.results_dir, "sample_gmm_sweep")

        outputs = []
        for p_idx in range(len(conds)):
            per_pose = []
            for c_idx, cname in enumerate(CLO_TYPES):
                pose_emb, clo_emb = self.engine.encode_only_condition(
                    conds[p_idx : p_idx + 1], clotypes[c_idx : c_idx + 1]
                )
                z = gmm.sample(prng.PRNGKey(int(self.rng.integers(1 << 30))), n)
                z_total = np.concatenate(
                    [z, np.repeat(pose_emb, n, 0), np.repeat(clo_emb, n, 0)], axis=-1
                )
                disp = self.engine.decode(z_total, pose_emb, clo_emb)
                full = self._disp_to_fullbody(disp * self.train_std + self.train_mean)
                pose_aa = np.repeat(self.demo_pose[p_idx : p_idx + 1], n, axis=0)
                self._export(
                    full, pose_aa, obj_dir, prefix=f"pose{p_idx}_{cname}"
                )
                per_pose.append(full)
            outputs.append(np.stack(per_pose))
        return np.stack(outputs)

    # ------------------------------------------------------------------
    def run(self):
        self.sample_vary_pose()
        self.sample_vary_clotype()

    # ------------------------------------------------------------------
    def _disp_to_fullbody(self, disp_mm: np.ndarray) -> np.ndarray:
        """Mask displacements to clothing vertices, add the minimal body
        (reference demos.py:93-96,158-161)."""
        masked = np.zeros_like(disp_mm)
        masked[:, self.clothing_verts_idx, :] = disp_mm[:, self.clothing_verts_idx, :]
        return masked + self.minimal_shape

    def _export(self, fullbody: np.ndarray, pose_aa: np.ndarray | None, obj_dir: str, prefix: str):
        if not (self.save_objs or self.vis):
            return
        os.makedirs(obj_dir, exist_ok=True)
        verts = fullbody
        if self.smpl is not None and pose_aa is not None:
            verts = lbs(
                self.smpl, pose_aa.astype(np.float32), v_template=fullbody.astype(np.float32)
            ).cpu().numpy()
        if self.save_objs:
            for i, v in enumerate(verts):
                save_obj(join(obj_dir, f"{prefix}_{i:04d}.obj"), v, self.faces)
        if self.vis:
            from cape_tpu_torch.meshops.render import contact_sheet
            from cape_tpu_torch.meshops.viewer import export_html

            contact_sheet(verts, self.faces, join(obj_dir, f"{prefix}_sheet.png"))
            # interactive surface (reference MeshViewers window): one
            # self-contained HTML file per batch — orbit/zoom in a browser
            export_html(
                verts, self.faces, join(obj_dir, f"{prefix}_viewer.html"),
                title=f"{self.name}: {prefix}",
            )


class SimpleDemo:
    """CPU clotype-sampling smoke demo (reference run_simple_demo.py):
    decode + .obj export, no SMPL posing required."""

    def __init__(self, engine: InferenceEngine, results_dir: str = "results/demo_results", seed: int = 123):
        self.suite = DemoSuite(
            engine,
            name="demo_results",
            n_sample=3,
            save_objs=True,
            smpl_model_folder="/nonexistent",  # force unposed export
            results_root=os.path.dirname(results_dir) or "results",
            seed=seed,
        )

    def run(self):
        return self.suite.sample_vary_clotype()
